"""Encode -> decode round trip of a chunk (port of
``repro.core.roundtrip``): ladder downscale, the I/P video encode, Eq. 3
classification, the JPEG anchor encode, the rate model and the 3-pipeline
decode-execute, full frame or ROI-gated, with any codec search and
storage dtype.

* ``roundtrip_chunk``: one stream.
* ``roundtrip_batched``: S streams of one HD shape and one rung.
* ``roundtrip_ladder_batched``: S streams of MIXED rungs on one padded LR
  canvas sized to the batch's largest rung; ``roundtrip_padded_batched``
  takes the canvas, extents and qualities as data (``full_lr_canvas``
  fixes the canvas whatever the rungs).
* ``roundtrip_oracle``: the composed execution the fused forms must
  agree with: ``encode_chunk``, a JPEG encode (and with the budget search
  a ladder probe) of each anchor on its own, ``decode_execute_chunk``.

Every form runs S streams as one batch: on CUDA each encode step launches
each kernel once for all S streams, and the decode half runs each kernel
once over all S*T frames.  Lane s of a batched or mixed-ladder form equals
``roundtrip_chunk`` on stream s at its own rung.

The anchor quality is pinned to ``cfg.anchor_quality``, or, with
``anchor_search=True``, chosen a frame from ``ANCHOR_QUALITY_LADDER``: the
highest rung whose bits fit the anchor's even share of the chunk's spare
bandwidth (``bw_kbps * 1000 * T/fps`` minus the video bits).  The fused
search charges every rung's bits with one blockdct launch a rung over the
chunk's anchors and reconstructs each anchor once, at its chosen rung.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.codec import blockdct as B
from repro_torch.codec.image_codec import (ANCHOR_QUALITY_LADDER,
                                           budget_rung, jpeg_encode_decode,
                                           ladder_bits, quality_for_budget)
from repro_torch.codec.rate_model import (QUALITY_LADDER, downscale,
                                          ladder_lr_shape, lr_shape_for_scale)
from repro_torch.codec.video_codec import (VideoCodecConfig, _encode_chunk,
                                           encode_chunk)
from repro_torch.core.classification import _classify_host, classify_frames
from repro_torch.core.hybrid_decoder import (PipelineCosts, _execute_chunk,
                                             decode_execute_chunk)
from repro_torch.core.roi import RoiConfig
from repro_torch.device import host_to_device, resolve_device
from repro_torch.models.detection import TinyDetectorConfig

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RoundtripConfig:
    """``level`` is the bitrate-ladder rung (§VI-A): it sets the LR shape
    and the codec quality.  ``roi`` gates the detector onto the top-K
    regions (None: full frame).  ``anchor_search`` swaps the pinned
    ``anchor_quality`` for the budget search over
    ``ANCHOR_QUALITY_LADDER``."""
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


def anchor_budget_bits(bw_kbps, video_bits, n_anchors, n_frames: int,
                       fps: float):
    """Per-anchor bit budget: the chunk's bandwidth allowance
    (bw_kbps * 1000 * T/fps) minus the video bits, split evenly across the
    chunk's anchors, in f32 (element-wise over streams)."""
    dev = video_bits.device if torch.is_tensor(video_bits) else None
    chunk_bits = torch.as_tensor(bw_kbps, dtype=f32, device=dev) * 1000.0 \
        * (n_frames / fps)
    spare = (chunk_bits - torch.as_tensor(video_bits, dtype=f32,
                                          device=dev)).clamp(min=0.0)
    return spare / torch.as_tensor(n_anchors, dtype=f32,
                                   device=dev).clamp(min=1.0)


def _params(detector_params, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev)
            for k, v in detector_params.items()}


def _lanes(dev, S: int, **scalars) -> dict:
    """Per-stream scalars as (S,) f32 tensors (one value serves all)."""
    return {k: torch.as_tensor(v, dtype=f32, device=dev).reshape(-1)
            .expand(S) for k, v in scalars.items()}


# frames of the anchor stage: "given", every frame it was handed, and
# "encoded", the frames it encoded (Eq. 3's anchors)
ANCHOR_FRAMES: collections.Counter = collections.Counter()


def _anchors(raw, types, video_bits, bw_kbps, cfg: RoundtripConfig):
    """The JPEG anchors of S streams' chunks, raw (S, T, H, W): only the
    type-1 frames of ``types`` (Eq. 3's types on the host, numpy (S, T))
    are encoded, and their results scattered into zeros, which are exact
    no-ops in every sum.  Returns (anchor_hd, anchor_bits (S,), anchor_q
    (S, T))."""
    S, T = types.shape
    dev = raw.device
    ids = np.flatnonzero(types == 1)
    ANCHOR_FRAMES["given"] += S * T
    ANCHOR_FRAMES["encoded"] += len(ids)
    idx = host_to_device(ids, dev)
    flat = raw.flatten(0, 1)
    sel = flat.index_select(0, idx)
    if cfg.anchor_search:
        # each anchor's bits at every rung, its even share of its stream's
        # spare bandwidth, the highest rung that fits; then one encode of
        # each anchor at its own rung's table
        bits = ladder_bits(sel)                              # (n1, Q)
        is1 = host_to_device((types == 1).astype(np.float32), dev)
        n_anchors = B.seq_sum(is1, 1)
        per_anchor = anchor_budget_bits(bw_kbps, video_bits, n_anchors, T,
                                        cfg.fps)
        rung = budget_rung(bits, per_anchor[idx // T])       # (n1,)
        qs = torch.tensor(ANCHOR_QUALITY_LADDER, dtype=f32, device=dev)
        tables = B.quant_table(ANCHOR_QUALITY_LADDER, dev)[rung]
        _, jrec = B.dct_quantize_raster(sel - 128.0, tables)
        jrec = (jrec + 128.0).clamp(0.0, 255.0)
        jbits = bits.gather(-1, rung[..., None])[..., 0]
        frame_q = qs[rung]
    else:
        # the anchors at the pinned quality, in one blockdct launch
        jrec, jbits = jpeg_encode_decode(sel, cfg.anchor_quality)
        frame_q = torch.full((len(ids),), cfg.anchor_quality, dtype=f32,
                             device=dev)
    jrec = torch.zeros_like(flat).index_copy_(0, idx, jrec)
    jbits = flat.new_zeros(S * T).index_copy_(0, idx, jbits)
    frame_q = flat.new_zeros(S * T).index_copy_(0, idx, frame_q)
    anchor_bits = B.seq_sum(jbits.reshape(S, T), 1)
    return jrec.reshape(raw.shape), anchor_bits, frame_q.reshape(S, T)


def _roundtrip_execute(raw, enc, lr_extent, gt_boxes, gt_valid, params,
                       lanes: dict, cfg: RoundtripConfig) -> dict:
    """Post-encode half for S streams, every input with a leading stream
    axis: classification, anchors, rate model, 3-pipeline execution."""
    video_bits = B.seq_sum(enc.bits, 1)
    types_host = _classify_host(enc.frame_diff / 255.0,
                                enc.residual_mag / 255.0, lanes["tr1"],
                                lanes["tr2"])[0]
    types = host_to_device(types_host, raw.device)
    anchor_hd, anchor_bits, anchor_q = _anchors(raw, types_host, video_bits,
                                                lanes["bw_kbps"], cfg)
    total_bits = video_bits + anchor_bits
    out = _execute_chunk(enc, types, anchor_hd, gt_boxes, gt_valid, params,
                         cfg.det_cfg, lanes["bw_kbps"], lanes["queue_delay"],
                         total_bits, cfg.costs, lr_extent=lr_extent,
                         roi=cfg.roi)
    out.update(types=types, video_bits=video_bits, anchor_bits=anchor_bits,
               total_bits=total_bits, anchor_q=anchor_q)
    return out


def _batch_inputs(raw, gt_boxes, gt_valid, detector_params, device,
                  **scalars):
    dev = resolve_device(device)
    raw = torch.as_tensor(raw, dtype=f32, device=dev)
    return (dev, raw, torch.as_tensor(gt_boxes, dtype=f32, device=dev),
            torch.as_tensor(gt_valid, device=dev),
            _params(detector_params, dev), _lanes(dev, raw.shape[0],
                                                  **scalars))


def _downscale(raw, level: int):
    """(S, T, H, W) HD frames -> their ladder rung's LR frames, a stream
    at a time: each stream's pooling is then the single-stream one."""
    return torch.stack([downscale(r, QUALITY_LADDER[level].scale)
                        for r in raw])


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
    out = roundtrip_batched(
        torch.as_tensor(raw)[None], torch.as_tensor(gt_boxes)[None],
        torch.as_tensor(gt_valid)[None], detector_params, tr1=tr1, tr2=tr2,
        bw_kbps=bw_kbps, queue_delay=queue_delay, cfg=cfg, device=device)
    return {k: v[0] for k, v in out.items()}


def roundtrip_batched(raw, gt_boxes, gt_valid, detector_params, *, tr1, tr2,
                      bw_kbps, queue_delay=0.0,
                      cfg: RoundtripConfig = RoundtripConfig(),
                      device=None) -> dict:
    """S streams of one HD shape at one rung: raw (S, T, H, W); the
    per-stream scalars (S,) or one for all; detector params shared.
    Returns the ``roundtrip_chunk`` dict with a leading stream axis.  On
    CUDA every kernel launches as often for S streams as for one."""
    _, raw, gt_boxes, gt_valid, params, lanes = _batch_inputs(
        raw, gt_boxes, gt_valid, detector_params, device, tr1=tr1, tr2=tr2,
        bw_kbps=bw_kbps, queue_delay=queue_delay)
    enc = _encode_chunk(_downscale(raw, cfg.level), cfg.codec_for())
    return _roundtrip_execute(raw, enc, None, gt_boxes, gt_valid, params,
                              lanes, cfg)


def ladder_batch_arrays(levels, H: int, W: int, *, device=None):
    """Per-rung LR shapes of an (H, W) source -> (extents (S, 2) int32,
    qualities (S,) f32) of a mixed-ladder batch, on the resolved
    device."""
    dev = resolve_device(device)
    extents = torch.tensor([ladder_lr_shape(level, H, W) for level in levels],
                           dtype=torch.int32, device=dev)
    qualities = torch.tensor([QUALITY_LADDER[level].quality
                              for level in levels], dtype=f32, device=dev)
    return extents, qualities


def _downscale_pad(raw, levels, canvas=None):
    """Each stream downscaled to its own rung, zero-padded onto ``canvas``
    (hp, wp), by default the batch's largest LR shape."""
    S, T, H, W = raw.shape
    shapes = [ladder_lr_shape(level, H, W) for level in levels]
    hp, wp = canvas or (max(h for h, _ in shapes), max(w for _, w in shapes))
    return torch.stack([
        torch.nn.functional.pad(downscale(raw[s],
                                          QUALITY_LADDER[level].scale),
                                (0, wp - w, 0, hp - h))
        for s, (level, (h, w)) in enumerate(zip(levels, shapes))])


def full_lr_canvas(H: int, W: int) -> tuple[int, int]:
    """The largest LR shape any ladder rung can produce for an (H, W)
    source: the fixed canvas of ``roundtrip_padded_batched``."""
    return lr_shape_for_scale(1.0, H, W)


def _roundtrip_ladder_body(raw, lr_pad, extents, qualities, gt_boxes,
                           gt_valid, params, lanes: dict,
                           cfg: RoundtripConfig) -> dict:
    enc = _encode_chunk(lr_pad, cfg.codec, extent=extents, quality=qualities)
    return _roundtrip_execute(raw, enc, extents, gt_boxes, gt_valid, params,
                              lanes, cfg)


def roundtrip_padded_batched(raw, lr_pad, extents, qualities, gt_boxes,
                             gt_valid, detector_params, *, tr1, tr2,
                             bw_kbps, queue_delay=0.0,
                             cfg: RoundtripConfig = RoundtripConfig(),
                             device=None) -> dict:
    """Mixed-ladder round trip with the rungs as data: the caller
    downscales each stream to its rung and pads onto one canvas
    (``full_lr_canvas`` for a canvas fixed whatever the rungs): lr_pad (S,
    T, Hp, Wp), extents (S, 2) valid (h, w), qualities (S,) codec quality
    factors.  ``cfg.level`` is ignored.  Lane s equals ``roundtrip_chunk``
    on stream s at its rung."""
    dev, raw, gt_boxes, gt_valid, params, lanes = _batch_inputs(
        raw, gt_boxes, gt_valid, detector_params, device, tr1=tr1, tr2=tr2,
        bw_kbps=bw_kbps, queue_delay=queue_delay)
    return _roundtrip_ladder_body(
        raw, torch.as_tensor(lr_pad, dtype=f32, device=dev),
        torch.as_tensor(extents, device=dev), qualities, gt_boxes, gt_valid,
        params, lanes, cfg)


def roundtrip_ladder_batched(raw, gt_boxes, gt_valid, detector_params, *,
                             tr1, tr2, bw_kbps, queue_delay=0.0,
                             levels: tuple,
                             cfg: RoundtripConfig = RoundtripConfig(),
                             device=None) -> dict:
    """Mixed bitrate-ladder rungs, one rung a stream (``levels``): each
    stream downscales to its rung and pads onto the batch's largest LR
    shape, then the masked encode and the extent-aware decode run all S
    streams at once.  ``cfg.level`` is ignored.  Lane s equals
    ``roundtrip_chunk(raw[s], ..., cfg=replace(cfg, level=levels[s]))``."""
    dev, raw, gt_boxes, gt_valid, params, lanes = _batch_inputs(
        raw, gt_boxes, gt_valid, detector_params, device, tr1=tr1, tr2=tr2,
        bw_kbps=bw_kbps, queue_delay=queue_delay)
    extents, qualities = ladder_batch_arrays(levels, *raw.shape[-2:],
                                             device=dev)
    return _roundtrip_ladder_body(raw, _downscale_pad(raw, levels), extents,
                                  qualities, gt_boxes, gt_valid, params,
                                  lanes, cfg)


def roundtrip_oracle(raw, gt_boxes, gt_valid, detector_params, *, tr1, tr2,
                     bw_kbps, queue_delay=0.0,
                     cfg: RoundtripConfig = RoundtripConfig(),
                     device=None) -> dict:
    """The composed execution: ``encode_chunk``, host-side classification
    and a JPEG encode of each anchor on its own (with the budget search, a
    ``quality_for_budget`` probe of each anchor first), then
    ``decode_execute_chunk``.  ``roundtrip_chunk`` must agree with it."""
    dev = resolve_device(device)
    raw = torch.as_tensor(raw, dtype=f32, device=dev)
    params = _params(detector_params, dev)
    enc = encode_chunk(_downscale(raw[None], cfg.level)[0], cfg.codec_for(),
                       device=dev)
    video_bits = B.seq_sum(enc.bits)
    types, _, _ = classify_frames(enc.frame_diff / 255.0,
                                  enc.residual_mag / 255.0, tr1, tr2)
    T = raw.shape[0]
    anchors = torch.nonzero(types.cpu() == 1).flatten().tolist()
    anchor_hd = torch.zeros_like(raw)
    anchor_bits = torch.zeros((), dtype=f32, device=dev)
    anchor_q = torch.zeros((T,), dtype=f32, device=dev)
    if cfg.anchor_search:
        per_anchor = anchor_budget_bits(bw_kbps, video_bits,
                                        float(len(anchors)), T, cfg.fps)
    for i in anchors:
        q_i = quality_for_budget(raw[i], per_anchor)[0] \
            if cfg.anchor_search else cfg.anchor_quality
        rec, bits = jpeg_encode_decode(raw[i], q_i)
        anchor_hd[i] = rec
        anchor_bits = anchor_bits + bits
        anchor_q[i] = q_i
    out = decode_execute_chunk(
        enc, types, anchor_hd, gt_boxes, gt_valid, params, cfg.det_cfg,
        bw_kbps=bw_kbps, queue_delay=queue_delay,
        total_bits=video_bits + anchor_bits, costs=cfg.costs, roi=cfg.roi,
        device=dev)
    out.update(types=types, video_bits=video_bits, anchor_bits=anchor_bits,
               total_bits=video_bits + anchor_bits, anchor_q=anchor_q)
    return out
