"""Hybrid encoder, paper §IV-A Fig. 5: the camera side (port of
``repro.core.hybrid_encoder``).

Per chunk: 1) the video encoder picks a (bitrate, resolution) ladder rung
from the allocated bandwidth (§VI-A's 5-rung ladder); 2) the agent's
thresholds (tr1, tr2) classify the frames from the codec's features (Eq.
3); 3) the image encoder JPEG-encodes the type-1 frames (anchors) at the
highest quality that fits what the video left of the stream's share.

The frames, the encode and the anchors stay on the device; the frame
types, the rung and the bit counts are host data, decided by host
control.  On CUDA a chunk launches: the video encode's kernels, one
``blockdct`` forward probing the first anchor at the five qualities (a
table a frame), one ``blockdct`` forward for every anchor at the chosen
quality, and a ``seq_sum`` for the video bits, the probe's bits and the
anchors' bits each.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.codec import blockdct as B
from repro_torch.codec.image_codec import jpeg_encode_decode
from repro_torch.codec.rate_model import (QUALITY_LADDER, downscale,
                                          ladder_for_bandwidth,
                                          video_bandwidth_share)
from repro_torch.codec.video_codec import (EncodedChunk, VideoCodecConfig,
                                           _encode_chunk)
from repro_torch.core.classification import classify_frames
from repro_torch.device import host_to_device, resolve_device

f32 = torch.float32

ANCHOR_QUALITIES = (25.0, 40.0, 55.0, 70.0, 85.0)


@dataclasses.dataclass
class HybridPacket:
    """What the camera ships to the edge for one chunk."""
    types: np.ndarray           # (T,) 1/2/3 pipeline assignment, host
    ladder_level: int
    video: EncodedChunk         # the LR encode, on the device
    anchor_hd: torch.Tensor     # (T, H, W) decoded anchors (0 elsewhere)
    anchor_quality: float
    video_bits: float
    anchor_bits: float
    lr_shape: tuple

    @property
    def total_bits(self) -> float:
        return float(self.video_bits + self.anchor_bits)


def _normalize_features(enc: EncodedChunk):
    """Codec features -> [0, ~1] classification features."""
    return enc.frame_diff / 255.0, enc.residual_mag / 255.0


def _probe_bits(frame, qualities=ANCHOR_QUALITIES):
    """The bits of ``jpeg_bits(frame, q)`` for each quality q, in one
    blockdct launch over copies of the frame, a table each."""
    H, W = frame.shape
    copies = frame.to(f32).expand(len(qualities), H, W) - 128.0
    q, _ = B.dct_quantize_raster(copies,
                                 B.quant_table(qualities, frame.device))
    return B.entropy_bits(q, grid=(H // 8, W // 8))


def encode_hybrid(raw_frames, bw_kbps: float, tr1: float, tr2: float,
                  fps: float = 30.0, codec_overrides: dict | None = None,
                  level: int | None = None, *, device=None) -> HybridPacket:
    """raw_frames: (T, H, W) [0..255], numpy or a tensor (kept on its
    device when that is the resolved one).

    ``codec_overrides`` replaces VideoCodecConfig fields, e.g.
    ``{"dtype": "bfloat16"}`` or ``{"search": "diamond"}``; the
    reference's ``use_kernel`` is accepted and has no effect (the port
    runs its kernels whenever the tensors are on CUDA).  ``level`` pins
    the ladder rung instead of deriving it from the bandwidth, as the
    runtime's degradation ladder does.  Runs on CUDA unless ``device``
    says otherwise.
    """
    dev = resolve_device(device)
    raw = torch.as_tensor(raw_frames, dtype=f32).to(dev)
    T, H, W = raw.shape
    budget_bits = bw_kbps * 1000.0 * (T / fps)

    # 1) ladder rung, with headroom reserved for the anchors
    if level is None:
        level = ladder_for_bandwidth(video_bandwidth_share(bw_kbps))
    elif not 0 <= level < len(QUALITY_LADDER):
        raise ValueError(f"ladder level {level} outside "
                         f"[0, {len(QUALITY_LADDER)})")
    ql = QUALITY_LADDER[level]
    frames_lr = downscale(raw, ql.scale)
    cfg = VideoCodecConfig(quality=ql.quality)
    overrides = {k: v for k, v in (codec_overrides or {}).items()
                 if k != "use_kernel"}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    enc = _encode_chunk(frames_lr[None], cfg).lane(0)

    # 2) classification on the host: the features and the video bits
    # cross in one copy
    fd, rm = _normalize_features(enc)
    host = torch.cat([fd, rm, B.seq_sum(enc.bits)[None]]).cpu()
    video_bits = float(host[2 * T])
    types = classify_frames(host[:T], host[T:2 * T], tr1, tr2)[0].numpy()
    anchor_ids = np.nonzero(types == 1)[0]

    # 3) anchors: the last quality whose probe of the first anchor fits
    # the even share of the leftover budget
    anchor_budget = max(budget_bits - video_bits, 0.0)
    per_anchor = anchor_budget / max(len(anchor_ids), 1)
    quality = ANCHOR_QUALITIES[0]
    probe = _probe_bits(raw[int(anchor_ids[0])]).tolist() \
        if len(anchor_ids) else [0.0] * len(ANCHOR_QUALITIES)
    for q, bits in zip(ANCHOR_QUALITIES, probe):
        if bits <= per_anchor:
            quality = q
    anchor_hd = torch.zeros_like(raw)
    anchor_bits = 0.0
    if len(anchor_ids):
        ids = host_to_device(anchor_ids, dev)
        rec, bits = jpeg_encode_decode(raw[ids], quality)
        anchor_hd[ids] = rec
        for b in bits.tolist():           # in frame order, in f64
            anchor_bits += b

    return HybridPacket(types=types, ladder_level=level, video=enc,
                        anchor_hd=anchor_hd, anchor_quality=float(quality),
                        video_bits=video_bits, anchor_bits=anchor_bits,
                        lr_shape=tuple(frames_lr.shape))
