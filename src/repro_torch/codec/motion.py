"""Block motion estimation and compensation, 16x16 macroblocks, +-R
integer pel (port of ``repro.codec.motion``).

Two search strategies, each in f32 or bf16 storage (inputs rounded to
bf16, every SAD summed in f32): ``search="exhaustive"`` evaluates all
(2R+1)^2 candidates; ``search="diamond"`` probes the 3x3 neighbourhood of
the running best at halving steps (``diamond_steps``), 37 evaluations per
block at R=8 instead of 289.  The diamond's SAD is never below the
exhaustive one: its probes are a subset of the candidates.

``block_sad`` goes through the ``motion_sad`` kernel's wrapper and
``warp_blocks`` through the ``qtransfer`` kernel's wrapper in its pixel
edge mode; each launches its CUDA kernel on CUDA tensors and runs its
plain PyTorch version on CPU tensors.  ``block_sad_scan`` (exhaustive)
and ``block_sad_diamond`` are the plain oracles on any device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.motion_sad.ops import (diamond_steps, motion_sad,
                                                motion_sad_diamond_plain)
from repro_torch.kernels.qtransfer.ops import qtransfer

f32 = torch.float32
MB = 16  # macroblock size


def _offsets(radius: int, device=None):
    """(K, 2) int32 candidate offsets (dy, dx), dy-major."""
    r = torch.arange(-radius, radius + 1, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dy.reshape(-1), dx.reshape(-1)], dim=1).to(
        torch.int32)


def block_sad_scan(cur, ref, radius: int = 8):
    """Scan-over-candidates full search, the oracle: one whole-frame
    shifted SAD per candidate offset, dy-major, strict ``<`` (the first
    of equal SADs wins).  Returns (mv (nby, nbx, 2) int32, sad f32)."""
    H, W = cur.shape
    nby, nbx = H // MB, W // MB
    refp = F.pad(ref.to(f32)[None, None], (radius,) * 4,
                 mode="replicate")[0, 0]
    cur = cur.to(f32)
    offs = _offsets(radius, cur.device)
    best_sad = torch.full((nby, nbx), float("inf"), dtype=f32,
                          device=cur.device)
    best_idx = torch.zeros((nby, nbx), dtype=torch.int64, device=cur.device)
    for k, (dy, dx) in enumerate(offs.tolist()):
        shifted = refp[radius + dy:radius + dy + H, radius + dx:radius + dx + W]
        sad = (cur - shifted).abs().reshape(nby, MB, nbx, MB).sum(dim=(1, 3))
        better = sad < best_sad
        best_sad = torch.where(better, sad, best_sad)
        best_idx = torch.where(better, k, best_idx)
    return offs[best_idx], best_sad


def diamond_num_evals(radius: int) -> int:
    """Candidates the diamond search evaluates per macroblock: the centre
    and 9 probes per step (37 at R=8, against (2R+1)^2 = 289)."""
    return 1 + 9 * len(diamond_steps(radius))


def block_sad_diamond(cur, ref, radius: int = 8, *, dtype=None):
    """The diamond search's plain oracle (any device, never the kernel):
    (mv, sad) as :func:`block_sad` with ``search="diamond"``."""
    return motion_sad_diamond_plain(cur, ref, radius, dtype=dtype)


def block_sad(cur, ref, radius: int = 8, *, dtype=None,
              search: str = "exhaustive"):
    """Returns (mv (..., nby, nbx, 2) int32, sad (..., nby, nbx) f32);
    cur/ref (H, W) or (T, H, W) with H, W multiples of 16.  ``dtype`` is
    the storage dtype (None for f32, or torch.bfloat16); ``search`` is
    "exhaustive" or "diamond" (ValueError otherwise)."""
    return motion_sad(cur.contiguous(), ref.contiguous(), radius,
                      dtype=dtype, search=search)


def warp_blocks(ref, mv):
    """Motion compensation: gather the 16x16 blocks of ``ref`` at MV
    offsets, edge-replicating each pixel (``repro.codec.motion.warp_blocks``
    semantics).  ref: (H, W) or (B, H, W); mv: (..., nby, nbx, 2) int32."""
    if ref.dim() == 2:
        return warp_blocks(ref[None], mv[None])[0]
    return qtransfer(ref.to(f32).contiguous(), mv.to(torch.int32).contiguous(),
                     edge="pixel")


def accumulate_mv(mvs):
    """Chain frame-to-previous MVs into anchor-relative ones by summation
    (paper Fig. 7): mvs (..., T, nby, nbx, 2) int32 -> its running sum
    over the frame axis, int32."""
    return torch.cumsum(mvs, dim=-4, dtype=torch.int32)
