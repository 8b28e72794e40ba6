"""Block-based video codec simulation: I/P frames, macroblock motion
vectors and a DCT-quantised residual (port of
``repro.codec.video_codec``, single stream, unmasked).

Chunks are (T, H, W) luma in [0, 255].  The P-frame loop is a Python loop
over frames; each P-frame launches one ``motion_sad`` (in the config's
search and storage dtype), one ``qtransfer`` (motion compensation) and
one ``blockdct`` kernel on CUDA.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.codec import blockdct as B
from repro_torch.codec import motion as M
from repro_torch.device import resolve_device

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class VideoCodecConfig:
    """The reference's codec config without ``use_kernel``: on CUDA the
    port always runs its kernels."""
    search_radius: int = 8
    quality: float = 50.0        # quantizer quality factor (QP analogue)
    gop: int = 30                # I-frame period
    dtype: str = "float32"       # search storage dtype: float32 | bfloat16
    search: str = "exhaustive"   # motion search strategy: exhaustive | diamond

    @property
    def search_dtype(self):
        """The motion search's storage dtype: torch.bfloat16 for
        "bfloat16"/"bf16", else None (f32)."""
        if self.dtype in ("bfloat16", "bf16"):
            return torch.bfloat16
        return None


@dataclasses.dataclass
class EncodedChunk:
    """Everything the edge receives for one chunk of one stream."""
    recon: torch.Tensor          # (T, H, W) decoder reconstruction
    mv: torch.Tensor             # (T, nby, nbx, 2) int32 (frame t-1 -> t)
    residual_q: torch.Tensor     # (T, nblocks, 8, 8) quantized residual coefs
    qtab: torch.Tensor           # (8, 8) quant table
    bits: torch.Tensor           # (T,) per-frame bit cost
    residual_mag: torch.Tensor   # (T,) mean |residual| per frame (R_f feature)
    frame_diff: torch.Tensor     # (T,) mean |frame_t - frame_{t-1}| (X_f)


def _mean_abs(x):
    """mean(|x|) as 16x16 tile partials, then the tile grid's total,
    times a correctly rounded f32 1/(H*W)."""
    H, W = x.shape
    tiles = x.abs().reshape(H // M.MB, M.MB, W // M.MB, M.MB).sum(dim=(1, 3))
    recip = float(np.float32(1.0) / np.float32(H * W))  # exact in f32
    return B.seq_sum(tiles) * recip


def _encode_iframe(frame, qtab):
    H, W = frame.shape
    q, rec = B.dct_quantize_raster(frame.to(f32) - 128.0, qtab)
    bits = B.entropy_bits(q, grid=(H // 8, W // 8))
    return (rec + 128.0).clamp(0.0, 255.0), q, bits


def _encode_pframe(frame, ref_recon, qtab, cfg: VideoCodecConfig):
    H, W = frame.shape
    mv, _ = M.block_sad(frame, ref_recon, cfg.search_radius,
                        dtype=cfg.search_dtype, search=cfg.search)
    pred = M.warp_blocks(ref_recon, mv)
    resid = frame.to(f32) - pred
    q, rec_resid = B.dct_quantize_raster(resid, qtab)
    bits = B.entropy_bits(q, grid=(H // 8, W // 8)) \
        + mv.numel() * 3.0                          # MV coding cost proxy
    rec = (pred + rec_resid).clamp(0.0, 255.0)
    return rec, mv, q, bits, _mean_abs(resid)


def _encode_chunk(frames, cfg: VideoCodecConfig) -> EncodedChunk:
    """frames: (T, H, W) on the device to encode on.  Frame 0 is the
    I-frame; every later frame is a P-frame predicted from the previous
    reconstruction."""
    T, H, W = frames.shape
    frames = frames.to(f32)
    qtab = B.quant_table(cfg.quality, frames.device)
    rec, q0, bits0 = _encode_iframe(frames[0], qtab)
    recs, qs, bits = [rec], [q0], [bits0]
    mvs = [torch.zeros((H // M.MB, W // M.MB, 2), dtype=torch.int32,
                       device=frames.device)]
    rmags = [_mean_abs(frames[0] - 128.0)]
    fdiffs = [torch.zeros((), dtype=f32, device=frames.device)]
    for t in range(1, T):
        prev = rec
        rec, mv, q, b, rmag = _encode_pframe(frames[t], prev, qtab, cfg)
        recs.append(rec)
        mvs.append(mv)
        qs.append(q)
        bits.append(b)
        rmags.append(rmag)
        fdiffs.append(_mean_abs(frames[t] - prev))
    return EncodedChunk(
        recon=torch.stack(recs), mv=torch.stack(mvs),
        residual_q=torch.stack(qs), qtab=qtab, bits=torch.stack(bits),
        residual_mag=torch.stack(rmags), frame_diff=torch.stack(fdiffs))


def encode_chunk(frames, cfg: VideoCodecConfig = VideoCodecConfig(), *,
                 device=None) -> EncodedChunk:
    """frames: (T, H, W) [0..255], numpy or tensor.  Frame 0 is the
    I-frame (chunks align to GOPs).  Runs on CUDA unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    return _encode_chunk(torch.as_tensor(frames, dtype=f32, device=dev), cfg)
