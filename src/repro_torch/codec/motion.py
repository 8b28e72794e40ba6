"""Block motion estimation and compensation, 16x16 macroblocks, +-R
integer pel (port of ``repro.codec.motion``, exhaustive f32 search).

``block_sad`` goes through the ``motion_sad`` kernel's wrapper and
``warp_blocks`` through the ``qtransfer`` kernel's wrapper in its pixel
edge mode; each launches its CUDA kernel on CUDA tensors and runs its
plain PyTorch version on CPU tensors.  ``block_sad_scan`` is the
whole-frame scan oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.motion_sad.ops import motion_sad
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


def block_sad(cur, ref, radius: int = 8, *, search: str = "exhaustive"):
    """Returns (mv (nby, nbx, 2) int32, sad (nby, nbx) f32) of the
    exhaustive +-R search; cur/ref (H, W) f32 with H, W multiples of 16.
    The diamond search and the bf16 variants are not ported yet."""
    if search != "exhaustive":
        raise NotImplementedError(
            f"search={search!r}: only the exhaustive search is ported")
    return motion_sad(cur.to(f32).contiguous(), ref.to(f32).contiguous(),
                      radius)


def warp_blocks(ref, mv):
    """Motion compensation: gather the 16x16 blocks of ``ref`` at MV
    offsets, edge-replicating each pixel (``repro.codec.motion.warp_blocks``
    semantics).  ref: (H, W) or (B, H, W); mv: (..., nby, nbx, 2) int32."""
    if ref.dim() == 2:
        return warp_blocks(ref[None], mv[None])[0]
    return qtransfer(ref.to(f32).contiguous(), mv.to(torch.int32).contiguous(),
                     edge="pixel")
