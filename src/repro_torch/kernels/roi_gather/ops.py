"""ROI patch gather: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``repro/kernels/roi_gather``.  The kernel is
``kernels/csrc/roi_gather.cu``; ``roi_gather_plain`` is the same function
in PyTorch (one advanced-indexing call on an ``unfold`` view), taken for
CPU tensors and used as the kernel's reference on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _check(planes, ry, rx, region_px: int, halo: int) -> int:
    """The patch side P; raises on shapes the gather does not take."""
    P = region_px + 2 * halo
    if planes.dim() != 3 or ry.dim() != 2 or ry.shape != rx.shape \
            or ry.shape[0] != planes.shape[0]:
        raise ValueError(f"planes must be (T, Hp, Wp) and ry/rx (T, K); got "
                         f"{tuple(planes.shape)}, {tuple(ry.shape)}, "
                         f"{tuple(rx.shape)}")
    if region_px <= 0 or halo < 0 or P > planes.shape[1] \
            or P > planes.shape[2]:
        raise ValueError(f"patch side {P} (region_px={region_px}, "
                         f"halo={halo}) does not fit planes "
                         f"{tuple(planes.shape)}")
    return P


def _start(r, region_px: int, n: int, P: int):
    """``lax.dynamic_slice``'s start of a P-long slice of an n-long axis at
    r * region_px: a negative start counts from the end, then the start
    is clamped to [0, n - P]."""
    s = r.long() * region_px
    return torch.where(s < 0, s + n, s).clamp(0, n - P)


def roi_gather_plain(planes, ry, rx, *, region_px: int, halo: int):
    """planes (T, Hp, Wp) halo-padded, ry/rx (T, K) region indices ->
    (T, K, P, P), P = region_px + 2*halo: the patch starting at
    (ry*region_px, rx*region_px), out-of-range starts treated as
    ``lax.dynamic_slice`` treats them (``roi_gather_ref``)."""
    P = _check(planes, ry, rx, region_px, halo)
    T, Hp, Wp = planes.shape
    windows = planes.unfold(1, P, 1).unfold(2, P, 1)  # every (P, P) window
    t = torch.arange(T, device=planes.device)[:, None]
    return windows[t, _start(ry, region_px, Hp, P),
                   _start(rx, region_px, Wp, P)]


roi_gather_ref = roi_gather_plain   # the reference's name for its oracle

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P]


def roi_gather(planes, ry, rx, *, region_px: int, halo: int):
    """Packed patch batch as :func:`roi_gather_plain`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (f32 planes, int32
    indices).  Raises under autograd."""
    P = _check(planes, ry, rx, region_px, halo)
    build.refuse_grad("roi_gather", planes, ry, rx)
    if planes.device.type == "cpu":
        return roi_gather_plain(planes, ry, rx, region_px=region_px,
                                halo=halo)
    if planes.device.type != "cuda":
        raise ValueError(f"roi_gather runs on cpu or cuda, not "
                         f"{planes.device}")
    build.check_cuda_tensor("planes", planes, torch.float32, planes.device)
    build.check_cuda_tensor("ry", ry, torch.int32, planes.device)
    build.check_cuda_tensor("rx", rx, torch.int32, planes.device)
    T, Hp, Wp = planes.shape
    K = ry.shape[1]
    out = torch.empty((T, K, P, P), dtype=torch.float32,
                      device=planes.device)
    fn = build.kernel_function("roi_gather", "roi_gather_launch", _ARGTYPES)
    build.launch("roi_gather", fn, planes.device, build.ptr(planes),
                 build.ptr(ry), build.ptr(rx), T, K, Hp, Wp, region_px, halo,
                 build.ptr(out))
    return out
