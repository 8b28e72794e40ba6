"""8x8 block DCT + quantisation and its inverse: the CUDA kernel's wrappers
and their plain PyTorch versions.

Port of ``repro/kernels/blockdct``.  The kernels are
``kernels/csrc/blockdct.cu``; the ``*_plain`` functions are the same
arithmetic in PyTorch, taken for CPU tensors and used as the kernels'
reference on the card.  Like the TPU kernel, both take the DCT matrix and
the quantisation table as arguments.

The raster entries take (F, H, W) frames and give the quantised
coefficients in block order, (F, nb, 8, 8) with nb = (H/8)(W/8) tiles
row-major over the frame, and the reconstruction in raster; the kernel
reads and writes the frames in place of a block-order copy.  The block
entries, on (nb, 8, 8) tiles, are the case F = nb, H = W = 8.  The table
is one (8, 8) quantisation table for every frame, or (F, 8, 8), one a
frame: a mixed-ladder batch quantises each stream at its own quality,
and the anchor budget search each frame at its own rung.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def blockify(img, block: int = 8):
    """(..., H, W) -> (..., H/b * W/b, b, b).  H, W multiples of b."""
    *lead, H, W = img.shape
    x = img.reshape(*lead, H // block, block, W // block, block)
    return x.transpose(-3, -2).reshape(*lead, -1, block, block)


def unblockify(blocks, H: int, W: int, block: int = 8):
    """(..., nb, b, b) -> (..., H, W)."""
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, H // block, W // block, block, block)
    return x.transpose(-3, -2).reshape(*lead, H, W)


def forward_quant_plain(blocks, dmat, qtab):
    """blocks (nb, 8, 8) -> (q = round(D x D^T / qtab),
    rec = D^T (q qtab) D); qtab (8, 8), or (nb, 8, 8), one a tile."""
    y = dmat @ blocks @ dmat.T
    q = torch.round(y / qtab)
    return q, inverse_plain(q, dmat, qtab)


def inverse_plain(q, dmat, qtab):
    """q (nb, 8, 8) -> rec = D^T (q qtab) D; qtab (8, 8) or (nb, 8, 8)."""
    return dmat.T @ (q * qtab) @ dmat


def _per_tile(qtab, F: int, nb: int):
    """The (8, 8) table, or each frame's of (F, 8, 8) repeated over its
    nb tiles: (F * nb, 8, 8)."""
    if qtab.dim() == 2:
        return qtab
    return qtab[:, None].expand(F, nb, 8, 8).reshape(F * nb, 8, 8)


def forward_quant_raster_plain(frames, dmat, qtab):
    """frames (F, H, W) -> (q (F, nb, 8, 8) in block order, rec (F, H, W)):
    :func:`forward_quant_plain` between a block-order copy and back; qtab
    (8, 8) or (F, 8, 8)."""
    F, H, W = frames.shape
    nb = (H // 8) * (W // 8)
    q, rec = forward_quant_plain(blockify(frames).reshape(-1, 8, 8), dmat,
                                 _per_tile(qtab, F, nb))
    return q.reshape(F, -1, 8, 8), unblockify(rec.reshape(F, -1, 8, 8), H, W)


def inverse_raster_plain(q, dmat, qtab, H: int, W: int):
    """q (F, nb, 8, 8) -> rec (F, H, W): :func:`inverse_plain`, back to
    raster; qtab (8, 8) or (F, 8, 8)."""
    rec = inverse_plain(q.reshape(-1, 8, 8), dmat,
                        _per_tile(qtab, q.shape[0], q.shape[1]))
    return unblockify(rec.reshape(q.shape), H, W)


_P = ctypes.c_void_p
_FORWARD_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_long, ctypes.c_int,
                     ctypes.c_int, _P, _P, _P]
_INVERSE_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_long, ctypes.c_int,
                     ctypes.c_int, _P, _P]


def _check(name, x, dmat, qtab, frames: int) -> int:
    """Raises on inputs the kernel does not take, and under autograd
    (every entry, on either device, passes here first); returns the
    table stride, 0 for one (8, 8) table or 64 for one a frame."""
    build.refuse_grad("blockdct", x, dmat, qtab)
    if dmat.shape != (8, 8) or qtab.shape not in ((8, 8), (frames, 8, 8)):
        raise ValueError(f"dmat and qtab must be (8, 8), or qtab "
                         f"({frames}, 8, 8) with one table a frame; got "
                         f"{tuple(dmat.shape)}, {tuple(qtab.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blockdct runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda":
        for n, t in ((name, x), ("dmat", dmat), ("qtab", qtab)):
            build.check_cuda_tensor(n, t, torch.float32, x.device)
            if t.data_ptr() % 16:
                raise ValueError(f"{n} must be 16-byte aligned")
    return 0 if qtab.dim() == 2 else 64


def forward_quant_raster(frames, dmat, qtab):
    """frames (F, H, W) f32, H and W multiples of 8, and qtab (8, 8) or
    (F, 8, 8) -> (q (F, nb, 8, 8) in block order, rec (F, H, W)) as
    :func:`forward_quant_raster_plain`.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted as
    ``blockdct_forward``)."""
    if frames.dim() != 3 or 0 in frames.shape or frames.shape[1] % 8 \
            or frames.shape[2] % 8:
        raise ValueError(f"frames must be (F, H, W) with F > 0 and H, W "
                         f"multiples of 8, got {tuple(frames.shape)}")
    qstride = _check("frames", frames, dmat, qtab, frames.shape[0])
    if frames.device.type == "cpu":
        return forward_quant_raster_plain(frames, dmat, qtab)
    F, H, W = frames.shape
    q = torch.empty((F, (H // 8) * (W // 8), 8, 8), dtype=torch.float32,
                    device=frames.device)
    rec = torch.empty_like(frames)
    fn = build.kernel_function("blockdct", "blockdct_forward_quant",
                               _FORWARD_ARGTYPES)
    build.launch("blockdct_forward", fn, frames.device, build.ptr(frames),
                 build.ptr(dmat), build.ptr(qtab), qstride, F, H, W,
                 build.ptr(q), build.ptr(rec))
    return q, rec


def inverse_raster(q, dmat, qtab, H: int, W: int):
    """q (F, (H/8)(W/8), 8, 8) f32 in block order and qtab (8, 8) or
    (F, 8, 8) -> rec (F, H, W) as :func:`inverse_raster_plain`.  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (counted as ``blockdct_inverse``)."""
    if q.dim() != 4 or q.shape[2:] != (8, 8) or q.shape[0] == 0 \
            or H <= 0 or W <= 0 or H % 8 or W % 8 \
            or q.shape[1] != (H // 8) * (W // 8):
        raise ValueError(f"q must be (F, (H/8)(W/8), 8, 8) with F > 0 for "
                         f"H, W multiples of 8; got {tuple(q.shape)} for "
                         f"{H}x{W}")
    qstride = _check("q", q, dmat, qtab, q.shape[0])
    if q.device.type == "cpu":
        return inverse_raster_plain(q, dmat, qtab, H, W)
    rec = torch.empty((q.shape[0], H, W), dtype=torch.float32,
                      device=q.device)
    fn = build.kernel_function("blockdct", "blockdct_inverse",
                               _INVERSE_ARGTYPES)
    build.launch("blockdct_inverse", fn, q.device, build.ptr(q),
                 build.ptr(dmat), build.ptr(qtab), qstride, q.shape[0], H, W,
                 build.ptr(rec))
    return rec


def _check_blocks(name, x):
    if x.dim() != 3 or x.shape[1:] != (8, 8) or x.shape[0] == 0:
        raise ValueError(f"{name} must be (nb, 8, 8) with nb > 0, "
                         f"got {tuple(x.shape)}")


def forward_quant(blocks, dmat, qtab):
    """blocks (nb, 8, 8) f32 -> (q, rec) as :func:`forward_quant_plain`.
    CPU tensors take the plain version; CUDA tensors the raster kernel on
    nb frames of 8x8."""
    _check_blocks("blocks", blocks)
    if blocks.device.type == "cpu":
        _check("blocks", blocks, dmat, qtab, blocks.shape[0])
        return forward_quant_plain(blocks, dmat, qtab)
    q, rec = forward_quant_raster(blocks, dmat, qtab)
    return q.reshape(blocks.shape), rec


def inverse(q, dmat, qtab):
    """q (nb, 8, 8) f32 -> rec as :func:`inverse_plain`.  CPU tensors take
    the plain version; CUDA tensors the raster kernel on nb frames of
    8x8."""
    _check_blocks("q", q)
    if q.device.type == "cpu":
        _check("q", q, dmat, qtab, q.shape[0])
        return inverse_plain(q, dmat, qtab)
    return inverse_raster(q[:, None], dmat, qtab, 8, 8)


def blockdct_quantize(blocks, quality):
    """blocks (nb, 8, 8) f32 at a JPEG quality -> (q, rec) as
    :func:`forward_quant` with the DCT matrix and the quality's table
    (``repro.kernels.blockdct.ops.blockdct_quantize``; the reference's
    ``tile`` and ``interpret`` are TPU knobs with no counterpart)."""
    from repro_torch.codec import blockdct as B   # it imports this module
    return forward_quant(blocks.to(torch.float32),
                         B.dct_matrix(8, blocks.device),
                         B.quant_table(quality, blocks.device))
