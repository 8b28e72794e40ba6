"""8x8 block DCT + quantisation and its inverse: the CUDA kernel's wrappers
and their plain PyTorch versions.

Port of ``repro/kernels/blockdct``.  The kernels are
``kernels/csrc/blockdct.cu``; the ``*_plain`` functions are the same
arithmetic in PyTorch, taken for CPU tensors and used as the kernels'
reference on the card.  Like the TPU kernel, both take the DCT matrix and
the quantisation table as arguments.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def forward_quant_plain(blocks, dmat, qtab):
    """blocks (nb, 8, 8) -> (q = round(D x D^T / qtab),
    rec = D^T (q qtab) D)."""
    y = dmat @ blocks @ dmat.T
    q = torch.round(y / qtab)
    return q, inverse_plain(q, dmat, qtab)


def inverse_plain(q, dmat, qtab):
    """q (nb, 8, 8) -> rec = D^T (q qtab) D."""
    return dmat.T @ (q * qtab) @ dmat


_P = ctypes.c_void_p
_FORWARD_ARGTYPES = [_P, _P, _P, ctypes.c_long, _P, _P, _P]
_INVERSE_ARGTYPES = [_P, _P, _P, ctypes.c_long, _P, _P]


def _check(name, x, dmat, qtab):
    if x.dim() != 3 or x.shape[1:] != (8, 8) or x.shape[0] == 0:
        raise ValueError(f"{name} must be (nb, 8, 8) with nb > 0, "
                         f"got {tuple(x.shape)}")
    if dmat.shape != (8, 8) or qtab.shape != (8, 8):
        raise ValueError("dmat and qtab must be (8, 8)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blockdct runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda":
        for n, t in ((name, x), ("dmat", dmat), ("qtab", qtab)):
            build.check_cuda_tensor(n, t, torch.float32, x.device)


def forward_quant(blocks, dmat, qtab):
    """blocks (nb, 8, 8) f32 -> (q, rec) as :func:`forward_quant_plain`.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check("blocks", blocks, dmat, qtab)
    if blocks.device.type == "cpu":
        return forward_quant_plain(blocks, dmat, qtab)
    q = torch.empty_like(blocks)
    rec = torch.empty_like(blocks)
    fn = build.kernel_function("blockdct", "blockdct_forward_quant",
                               _FORWARD_ARGTYPES)
    build.launch("blockdct_forward", fn, build.ptr(blocks), build.ptr(dmat),
                 build.ptr(qtab), blocks.shape[0], build.ptr(q),
                 build.ptr(rec), build.stream_ptr(blocks.device))
    return q, rec


def inverse(q, dmat, qtab):
    """q (nb, 8, 8) f32 -> rec as :func:`inverse_plain`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check("q", q, dmat, qtab)
    if q.device.type == "cpu":
        return inverse_plain(q, dmat, qtab)
    rec = torch.empty_like(q)
    fn = build.kernel_function("blockdct", "blockdct_inverse",
                               _INVERSE_ARGTYPES)
    build.launch("blockdct_inverse", fn, build.ptr(q), build.ptr(dmat),
                 build.ptr(qtab), q.shape[0], build.ptr(rec),
                 build.stream_ptr(q.device))
    return rec
