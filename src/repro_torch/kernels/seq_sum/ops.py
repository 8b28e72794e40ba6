"""Order-stable sum of a grid of partials: the CUDA kernel's wrapper and its
plain PyTorch version.

The reference (``repro.codec.blockdct.seq_sum``) sums with ``lax.scan``:
each row strictly left to right in f32, then the row totals in row order.
That order makes zeroed padding (a column suffix within each row, a suffix
of all-zero rows) an exact no-op, which the mixed-ladder encode needs.
The kernel is ``kernels/csrc/seq_sum.cu``; ``seq_sum_plain`` is the same
add sequence in PyTorch, taken for CPU tensors and used as the kernel's
reference on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

f32 = torch.float32
# the kernel keeps a lane's row totals in 48 KB of shared memory
MAX_ROWS = 48 * 1024 // 4


def seq_sum_plain(x):
    """x (L, R, C) f32 -> (L,): for every lane, each row scanned left to
    right, then the row totals scanned in row order.  One vectorised f32
    add a column across all rows and lanes, then one a row: the add
    sequence of the reference's vmapped ``lax.scan``."""
    L, R, C = x.shape
    rows = torch.zeros((L, R), dtype=f32, device=x.device)
    for c in range(C):
        rows = rows + x[:, :, c]
    total = torch.zeros((L,), dtype=f32, device=x.device)
    for r in range(R):
        total = total + rows[:, r]
    return total


_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_long, ctypes.c_int, ctypes.c_int, _P, _P]


def seq_sum(x):
    """x (L, R, C) f32 -> (L,) as :func:`seq_sum_plain`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted as
    ``seq_sum``), which takes R <= MAX_ROWS.  Raises under autograd."""
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (L, R, C) grid, got "
                         f"{tuple(x.shape)}")
    if x.dtype != f32:
        raise TypeError(f"x has dtype {x.dtype}, expected {f32}")
    build.refuse_grad("seq_sum", x)
    if x.device.type == "cpu":
        return seq_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"seq_sum runs on cpu or cuda, not {x.device}")
    L, R, C = x.shape
    if R > MAX_ROWS:
        raise ValueError(f"seq_sum takes at most {MAX_ROWS} rows on CUDA, "
                         f"got {R}")
    x = x.contiguous()
    build.check_cuda_tensor("x", x, f32, x.device)
    out = torch.empty((L,), dtype=f32, device=x.device)
    fn = build.kernel_function("seq_sum", "seq_sum_launch", _ARGTYPES)
    build.launch("seq_sum", fn, x.device, build.ptr(x), L, R, C,
                 build.ptr(out))
    return out
