"""Exhaustive block-matching motion search: the CUDA kernel's wrapper and
its plain PyTorch version.

Port of ``repro/kernels/motion_sad`` (exhaustive mode, f32).  The kernel
is ``kernels/csrc/motion_sad.cu``; ``motion_sad_plain`` is the same
function in PyTorch, taken for CPU tensors and used as the kernel's
reference on the card.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MB = 16


def motion_sad_plain(cur, ref, radius: int = 8):
    """Per-macroblock form of the search (``repro.codec.motion.block_sad``):
    each block's (MB+2R)^2 edge-padded window is cut once, candidates run
    dy-major and a strict ``<`` keeps the first of equal SADs.  Returns
    (mv (nby, nbx, 2) int32 (dy, dx), sad (nby, nbx) f32)."""
    H, W = cur.shape
    nby, nbx = H // MB, W // MB
    win = MB + 2 * radius
    refp = F.pad(ref[None, None], (radius,) * 4, mode="replicate")[0, 0]
    wins = refp.unfold(0, win, MB).unfold(1, win, MB)  # (nby, nbx, win, win)
    curb = cur.reshape(nby, MB, nbx, MB).permute(0, 2, 1, 3)
    side = 2 * radius + 1
    best_sad = torch.full((nby, nbx), float("inf"), dtype=torch.float32,
                          device=cur.device)
    best_idx = torch.zeros((nby, nbx), dtype=torch.int64, device=cur.device)
    for k in range(side * side):
        oy, ox = divmod(k, side)
        cand = wins[:, :, oy:oy + MB, ox:ox + MB]
        sad = (curb - cand).abs().sum(dim=(2, 3))
        better = sad < best_sad
        best_sad = torch.where(better, sad, best_sad)
        best_idx = torch.where(better, k, best_idx)
    mv = torch.stack([best_idx // side - radius, best_idx % side - radius],
                     dim=-1)
    return mv.to(torch.int32), best_sad


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def motion_sad(cur, ref, radius: int = 8):
    """cur/ref: (H, W) f32, H and W multiples of 16 -> (mv, sad) as in
    :func:`motion_sad_plain`.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if cur.shape != ref.shape or cur.dim() != 2 \
            or cur.shape[0] % MB or cur.shape[1] % MB:
        raise ValueError(f"cur/ref must be equal (H, W) with H, W multiples "
                         f"of {MB}; got {tuple(cur.shape)}, "
                         f"{tuple(ref.shape)}")
    if cur.device.type == "cpu":
        return motion_sad_plain(cur, ref, radius)
    if cur.device.type != "cuda":
        raise ValueError(f"motion_sad runs on cpu or cuda, not {cur.device}")
    for name, t in (("cur", cur), ("ref", ref)):
        build.check_cuda_tensor(name, t, torch.float32, cur.device)
    H, W = cur.shape
    mv = torch.empty((H // MB, W // MB, 2), dtype=torch.int32,
                     device=cur.device)
    sad = torch.empty((H // MB, W // MB), dtype=torch.float32,
                      device=cur.device)
    fn = build.kernel_function("motion_sad", "motion_sad_launch", _ARGTYPES)
    build.launch("motion_sad", fn, build.ptr(cur), build.ptr(ref), H, W,
                 radius, build.ptr(mv), build.ptr(sad),
                 build.stream_ptr(cur.device))
    return mv, sad
