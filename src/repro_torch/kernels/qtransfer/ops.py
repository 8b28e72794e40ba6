"""Macroblock gather at motion vectors (+ residual add and clip): the CUDA
kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/qtransfer``.  The kernel is
``kernels/csrc/qtransfer.cu``; ``qtransfer_plain`` is the same function in
PyTorch, taken for CPU tensors and used as the kernel's reference on the
card.  Two edge modes, which differ at the borders and must not be
swapped:

* ``edge="pixel"`` reproduces ``repro.codec.motion.warp_blocks`` (the
  main path): each pixel is edge-replicated on both axes, and a block
  start beyond the 16-px pad behaves as ``lax.dynamic_slice`` makes it
  (a negative start counts from the end, then clamps), for any |mv|.
* ``edge="block"`` reproduces ``repro.kernels.qtransfer.ref.qtransfer_ref``:
  dy clamped to +-``radius``, the block's x start clamped to [0, W-16].
  With ``dtype=torch.bfloat16`` it follows
  ``repro.kernels.qtransfer.ops.qtransfer(dtype=bf16)``: anchor and
  residual stored as bf16, gather and add in f32, clip, output in bf16.
  The pixel mode is f32 only: the reference has no bf16 ``warp_blocks``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MB = 16
EDGES = ("pixel", "block")
f32 = torch.float32


def _padded_start(s, n: int):
    """``lax.dynamic_slice``'s start of a 16-wide slice of an (n + 32)-long
    edge-padded axis: a negative start counts from the end (Python-style),
    then the start is clamped to [0, n + 16]."""
    return torch.where(s < 0, s + n + 2 * MB, s).clamp(0, n + MB)


def _source_index(mv, H: int, W: int, edge: str, radius: int):
    """(B, H, W) flat source index into each (H, W) frame."""
    dev = mv.device
    y = torch.arange(H, device=dev)
    x = torch.arange(W, device=dev)
    by, i = (y // MB)[:, None], (y % MB)[:, None]
    bx, j = (x // MB)[None, :], (x % MB)[None, :]
    m = mv.long()
    dy = m[:, :, :, 0][:, y // MB][:, :, x // MB]
    dx = m[:, :, :, 1][:, y // MB][:, :, x // MB]
    if edge == "pixel":
        start_y = _padded_start(by * MB + MB + dy, H)
        start_x = _padded_start(bx * MB + MB + dx, W)
        sy = (start_y - MB + i).clamp(0, H - 1)
        sx = (start_x - MB + j).clamp(0, W - 1)
    else:
        sy = (by * MB + dy.clamp(-radius, radius) + i).clamp(0, H - 1)
        sx = (bx * MB + dx).clamp(0, W - MB) + j
    return sy * W + sx


def _stored(anchor, resid, dtype):
    """anchor and resid in the storage dtype (None keeps them)."""
    if dtype is None:
        return anchor, resid
    return anchor.to(dtype), None if resid is None else resid.to(dtype)


def qtransfer_plain(anchor, mv, resid=None, *, edge: str = "pixel",
                    radius: int = 16, dtype=None):
    """anchor (B, H, W), mv (B, H/16, W/16, 2) int32, resid (B, H, W) or
    None -> (B, H, W) in the storage dtype: the gathered blocks, plus
    ``resid`` (added in f32) and clipped to [0, 255] when a residual is
    given."""
    B, H, W = anchor.shape
    anchor, resid = _stored(anchor, resid, dtype)
    idx = _source_index(mv, H, W, edge, radius)
    out = anchor.to(f32).reshape(B, H * W).gather(1, idx.reshape(B, H * W))
    out = out.reshape(B, H, W)
    if resid is not None:
        out = (out + resid.to(f32)).clamp(0.0, 255.0)
    return out.to(anchor.dtype)


_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_long, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P]


def qtransfer(anchor, mv, resid=None, *, edge: str = "pixel",
              radius: int = 16, dtype=None):
    """Batched gather as :func:`qtransfer_plain`.  ``dtype`` is the
    storage dtype: None (the inputs' own, f32 on a kernel) or
    torch.bfloat16, in the block mode only.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted as ``qtransfer`` or
    ``qtransfer_bf16``).  Raises under autograd."""
    build.refuse_grad("qtransfer", anchor, mv, resid)
    if edge not in EDGES:
        raise ValueError(f"edge must be one of {EDGES}, got {edge!r}")
    store = build.storage_dtype(dtype)
    if store == torch.bfloat16 and edge != "block":
        raise ValueError("the bf16 storage variant exists in the block edge "
                         "mode only (the reference has no bf16 warp_blocks)")
    if anchor.dim() != 3 or anchor.shape[1] % MB or anchor.shape[2] % MB:
        raise ValueError(f"anchor must be (B, H, W) with H, W multiples of "
                         f"{MB}, got {tuple(anchor.shape)}")
    B, H, W = anchor.shape
    if mv.shape != (B, H // MB, W // MB, 2):
        raise ValueError(f"mv must be {(B, H // MB, W // MB, 2)}, "
                         f"got {tuple(mv.shape)}")
    if resid is not None and resid.shape != anchor.shape:
        raise ValueError(f"resid must be {tuple(anchor.shape)}, "
                         f"got {tuple(resid.shape)}")
    if anchor.device.type == "cpu":
        return qtransfer_plain(anchor, mv, resid, edge=edge, radius=radius,
                               dtype=dtype)
    if anchor.device.type != "cuda":
        raise ValueError(f"qtransfer runs on cpu or cuda, not {anchor.device}")
    bf16 = store == torch.bfloat16
    anchor, resid = _stored(anchor, resid, dtype)
    build.check_cuda_tensor("anchor", anchor, store, anchor.device)
    build.check_cuda_tensor("mv", mv, torch.int32, anchor.device)
    if resid is not None:
        build.check_cuda_tensor("resid", resid, store, anchor.device)
    # the kernel moves 16 bytes of a row at a time and each MV as 8 bytes
    for name, t, align in (("anchor", anchor, 16), ("resid", resid, 16),
                           ("mv", mv, 8)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    out = torch.empty_like(anchor)
    fn = build.kernel_function("qtransfer", "qtransfer_launch", _ARGTYPES)
    build.launch("qtransfer_bf16" if bf16 else "qtransfer", fn,
                 anchor.device, build.ptr(anchor), build.ptr(mv),
                 None if resid is None else build.ptr(resid), B, H, W,
                 EDGES.index(edge), radius, int(bf16), build.ptr(out))
    return out
