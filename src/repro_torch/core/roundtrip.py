"""Encode -> decode round trip of one chunk of one stream (port of
``repro.core.roundtrip``: the pinned-anchor-quality path, full frame or
ROI-gated, with any codec search and storage dtype).

``roundtrip_chunk`` runs ladder downscale, the I/P video encode, Eq. 3
classification, the JPEG anchor encode of every frame (one batched
blockdct launch, masked to the type-1 frames), the rate model and the
3-pipeline decode-execute.  ``roundtrip_oracle`` composes the same steps
the way the reference's oracle does: a per-anchor JPEG loop between the
encode and ``decode_execute_chunk``.  The anchor budget search
(``anchor_search=True``) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.codec import blockdct as B
from repro_torch.codec.image_codec import jpeg_encode_decode
from repro_torch.codec.rate_model import QUALITY_LADDER, downscale
from repro_torch.codec.video_codec import (VideoCodecConfig, _encode_chunk,
                                           encode_chunk)
from repro_torch.core.classification import classify_frames
from repro_torch.core.hybrid_decoder import (PipelineCosts, _execute_chunk,
                                             decode_execute_chunk)
from repro_torch.core.roi import RoiConfig
from repro_torch.device import resolve_device
from repro_torch.models.detection import TinyDetectorConfig

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RoundtripConfig:
    """``level`` is the bitrate-ladder rung (§VI-A): it sets the LR shape
    and the codec quality.  ``roi`` gates the detector onto the top-K
    regions (None: full frame).  ``anchor_search`` must stay False: the
    anchor budget search is not ported yet."""
    level: int = 2
    codec: VideoCodecConfig = VideoCodecConfig()
    anchor_quality: float = 70.0
    det_cfg: TinyDetectorConfig = TinyDetectorConfig()
    costs: PipelineCosts = PipelineCosts()
    fps: float = 30.0
    roi: RoiConfig | None = None
    anchor_search: bool = False

    def codec_for(self, level: int | None = None) -> VideoCodecConfig:
        ql = QUALITY_LADDER[self.level if level is None else level]
        return dataclasses.replace(self.codec, quality=ql.quality)


def _check_ported(cfg: RoundtripConfig) -> None:
    if cfg.anchor_search:
        raise NotImplementedError(
            "RoundtripConfig.anchor_search is not ported yet")


def anchor_budget_bits(bw_kbps, video_bits, n_anchors, n_frames: int,
                       fps: float):
    """Per-anchor bit budget: the chunk's bandwidth allowance
    (bw_kbps * 1000 * T/fps) minus the video bits, split evenly across the
    chunk's anchors, in f32."""
    dev = video_bits.device if torch.is_tensor(video_bits) else None
    chunk_bits = torch.as_tensor(bw_kbps, dtype=f32, device=dev) * 1000.0 \
        * (n_frames / fps)
    spare = (chunk_bits - torch.as_tensor(video_bits, dtype=f32,
                                          device=dev)).clamp(min=0.0)
    return spare / torch.as_tensor(n_anchors, dtype=f32,
                                   device=dev).clamp(min=1.0)


def _inputs(raw, gt_boxes, gt_valid, detector_params, device):
    dev = resolve_device(device)
    return (dev, torch.as_tensor(raw, dtype=f32, device=dev),
            torch.as_tensor(gt_boxes, dtype=f32, device=dev),
            torch.as_tensor(gt_valid, device=dev),
            {k: torch.as_tensor(v, device=dev)
             for k, v in detector_params.items()})


def _finish(out: dict, types, video_bits, anchor_bits, anchor_q) -> dict:
    out.update(types=types, video_bits=video_bits, anchor_bits=anchor_bits,
               total_bits=video_bits + anchor_bits, anchor_q=anchor_q)
    return out


def _roundtrip_execute(raw, enc, gt_boxes, gt_valid, params, tr1, tr2,
                       bw_kbps, queue_delay, cfg: RoundtripConfig) -> dict:
    """Post-encode half: classification, anchors, rate model, 3-pipeline
    execution, on tensors already on the device."""
    video_bits = B.seq_sum(enc.bits)
    types, _, _ = classify_frames(enc.frame_diff / 255.0,
                                  enc.residual_mag / 255.0, tr1, tr2)
    is1 = types == 1
    # JPEG-encode EVERY frame at the pinned quality in one blockdct launch
    # and mask to the type-1 frames
    jrec, jbits = jpeg_encode_decode(raw, cfg.anchor_quality)
    anchor_hd = torch.where(is1[:, None, None], jrec, 0.0)
    anchor_bits = B.seq_sum(torch.where(is1, jbits, 0.0))
    anchor_q = torch.where(is1, cfg.anchor_quality, 0.0)
    out = _execute_chunk(enc, types, anchor_hd, gt_boxes, gt_valid, params,
                         cfg.det_cfg, bw_kbps, queue_delay,
                         video_bits + anchor_bits, cfg.costs, roi=cfg.roi)
    return _finish(out, types, video_bits, anchor_bits, anchor_q)


def roundtrip_chunk(raw, gt_boxes, gt_valid, detector_params, *, tr1, tr2,
                    bw_kbps, queue_delay=0.0,
                    cfg: RoundtripConfig = RoundtripConfig(),
                    device=None) -> dict:
    """One chunk of one stream, source frames -> HD detections.

    raw: (T, H, W) [0..255]; gt_boxes/gt_valid: (T, N, 4)/(T, N);
    detector_params: the port's parameter dict.  Inputs may be numpy or
    tensors; all are moved to the resolved device (CUDA unless ``device``
    says otherwise).  Returns the ``decode_execute_chunk`` dict plus
    types/video_bits/anchor_bits/total_bits/anchor_q.
    """
    _check_ported(cfg)
    _, raw, gt_boxes, gt_valid, params = _inputs(
        raw, gt_boxes, gt_valid, detector_params, device)
    lr = downscale(raw, QUALITY_LADDER[cfg.level].scale)
    enc = _encode_chunk(lr, cfg.codec_for())
    return _roundtrip_execute(raw, enc, gt_boxes, gt_valid, params, tr1,
                              tr2, bw_kbps, queue_delay, cfg)


def roundtrip_oracle(raw, gt_boxes, gt_valid, detector_params, *, tr1, tr2,
                     bw_kbps, queue_delay=0.0,
                     cfg: RoundtripConfig = RoundtripConfig(),
                     device=None) -> dict:
    """The composed execution: ``encode_chunk``, host-side classification
    and a JPEG encode of each anchor on its own, then
    ``decode_execute_chunk``.  ``roundtrip_chunk`` must agree with it."""
    _check_ported(cfg)
    dev, raw, gt_boxes, gt_valid, params = _inputs(
        raw, gt_boxes, gt_valid, detector_params, device)
    lr = downscale(raw, QUALITY_LADDER[cfg.level].scale)
    enc = encode_chunk(lr, cfg.codec_for(), device=dev)
    video_bits = B.seq_sum(enc.bits)
    types, _, _ = classify_frames(enc.frame_diff / 255.0,
                                  enc.residual_mag / 255.0, tr1, tr2)
    T = raw.shape[0]
    anchor_hd = torch.zeros_like(raw)
    anchor_bits = torch.zeros((), dtype=f32, device=dev)
    anchor_q = torch.zeros((T,), dtype=f32, device=dev)
    for i in torch.nonzero(types.cpu() == 1).flatten().tolist():
        rec, bits = jpeg_encode_decode(raw[i], cfg.anchor_quality)
        anchor_hd[i] = rec
        anchor_bits = anchor_bits + bits
        anchor_q[i] = cfg.anchor_quality
    out = decode_execute_chunk(
        enc, types, anchor_hd, gt_boxes, gt_valid, params, cfg.det_cfg,
        bw_kbps=bw_kbps, queue_delay=queue_delay,
        total_bits=video_bits + anchor_bits, costs=cfg.costs, roi=cfg.roi,
        device=dev)
    return _finish(out, types, video_bits, anchor_bits, anchor_q)
