"""8x8 block DCT + quantisation, the JPEG/H.264 transform core (port of
``repro.codec.blockdct``).

``dct_quantize_raster`` and ``dequant_idct_raster`` are the codec's
transform entries: raster frames in, quantised coefficients in block order
and raster reconstructions out, through the ``blockdct`` kernel's wrappers,
which launch the CUDA kernel on CUDA tensors and run the plain PyTorch
version on CPU tensors.  ``dct_quantize``/``dequant_idct`` take tiles in
block order.  ``dct2``/``idct2``/``quantize_with_table`` are the codec's
plain pieces, kept for the parity tests and the oracle.  The transform
entries take one (8, 8) quantisation table, or one a frame.

``seq_sum`` is the reference's order-stable sum (the ``seq_sum`` kernel on
CUDA), and ``entropy_bits`` charges bits only for the blocks a mask keeps:
zeroed padding is then an exact no-op, which the mixed-ladder encode's
lanes need to equal the unpadded encode.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels.blockdct import ops as blockdct_ops
from repro_torch.kernels.blockdct.ops import blockify, unblockify  # noqa: F401
from repro_torch.kernels.seq_sum import ops as seq_sum_ops

f32 = torch.float32

# Standard JPEG luminance quantization table (quality 50).
JPEG_LUMA_Q50 = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)


def dct_matrix(n: int = 8, device=None):
    """Orthonormal DCT-II matrix D (f32) such that y = D @ x @ D.T, built
    in numpy exactly as the reference builds it.  Cached per device (one
    host-to-device copy); callers must not modify it."""
    return _dct_matrix(n, torch.device("cpu" if device is None else device))


@functools.lru_cache()
def _dct_matrix(n: int, device: torch.device):
    k = np.arange(n, dtype=np.float32)[:, None]
    i = np.arange(n, dtype=np.float32)[None, :]
    d = np.cos((2 * i + 1) * k * math.pi / (2 * n)) * math.sqrt(2.0 / n)
    d[0] *= 1.0 / math.sqrt(2.0)
    return torch.from_numpy(d).to(device)


def quality_scale(quality):
    """JPEG quality-factor -> quant-table scale (Annex K convention), f32."""
    q = torch.as_tensor(quality, dtype=f32).clamp(1.0, 100.0)
    return torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q) / 100.0


def quant_table(quality, device=None):
    """The (8, 8) f32 quantization table for a quality factor, or (..., 8,
    8) tables for a tensor (or sequence) of them, computed on the CPU."""
    scale = quality_scale(torch.as_tensor(quality, dtype=f32).cpu())
    qtab = torch.from_numpy(JPEG_LUMA_Q50) * scale[..., None, None]
    return qtab.clamp(min=1.0).to(device, non_blocking=True)


def dct2(blocks):
    D = dct_matrix(blocks.shape[-1], blocks.device)
    return D @ blocks.to(f32) @ D.T


def idct2(coefs):
    D = dct_matrix(coefs.shape[-1], coefs.device)
    return D.T @ coefs.to(f32) @ D


def quantize_with_table(coefs, qtab):
    return torch.round(coefs / qtab)


def quantize(coefs, quality):
    """(round(coefs / table), table) for a quality factor."""
    qtab = quant_table(quality, coefs.device)
    return quantize_with_table(coefs, qtab), qtab


def dequantize(qcoefs, qtab):
    return qcoefs * qtab


def _frame_tables(qtab, lead):
    """One (8, 8) table, or a table a frame: (..., 8, 8) tables
    broadcast over the frames' leading axes ``lead`` and flattened to
    (F, 8, 8).  A batch of one table is the (8, 8) form."""
    if qtab.dim() == 2 or qtab.shape[:-2].numel() == 1:
        return qtab.reshape(8, 8).contiguous()
    return qtab.expand(*lead, 8, 8).reshape(-1, 8, 8).contiguous()


def dct_quantize_raster(frames, qtab):
    """(..., H, W) frames, H and W multiples of 8 -> (q (..., nb, 8, 8) in
    block order, rec (..., H, W) in raster): quantised DCT coefficients
    and the dequantised inverse transform, in ONE blockdct launch for
    every frame.  qtab: (8, 8), or tables broadcast over the leading axes
    (one a stream, one a frame)."""
    *lead, H, W = frames.shape
    q, rec = blockdct_ops.forward_quant_raster(
        frames.reshape(-1, H, W).contiguous(),
        dct_matrix(8, frames.device), _frame_tables(qtab, lead))
    return q.reshape(*lead, -1, 8, 8), rec.reshape(frames.shape)


def dequant_idct_raster(q, qtab, H: int, W: int):
    """(..., nb, 8, 8) quantised coefficients in block order -> (..., H, W)
    pixel-domain frames, in ONE blockdct inverse launch; qtab as for
    :func:`dct_quantize_raster`."""
    lead = q.shape[:-3]
    rec = blockdct_ops.inverse_raster(
        q.reshape(-1, *q.shape[-3:]).contiguous(), dct_matrix(8, q.device),
        _frame_tables(qtab, lead), H, W)
    return rec.reshape(*lead, H, W)


def dct_quantize(blocks, qtab):
    """(..., nb, 8, 8) tiles in block order -> (q, rec) of the same shape,
    in ONE blockdct launch."""
    shape = blocks.shape
    q, rec = blockdct_ops.forward_quant(
        blocks.reshape(-1, 8, 8).contiguous(),
        dct_matrix(8, blocks.device), qtab)
    return q.reshape(shape), rec.reshape(shape)


def dequant_idct(q, qtab):
    """(..., nb, 8, 8) quantised coefficients -> pixel-domain tiles, in ONE
    blockdct inverse launch."""
    rec = blockdct_ops.inverse(q.reshape(-1, 8, 8).contiguous(),
                               dct_matrix(8, q.device), qtab)
    return rec.reshape(q.shape)


def seq_sum(v, dims: int | None = None):
    """The reference's order-stable sum over the trailing ``dims`` axes
    (default: all of a 1-D vector or 2-D grid), in f32: a vector is one
    strict left-to-right scan; a 2-D grid scans each row, then the row
    totals.  Leading axes are independent lanes (streams x frames), all
    summed in ONE ``seq_sum`` launch on CUDA.  Zero padding appended to
    the rows or as whole rows adds exact no-ops, so a padded grid sums
    bit for bit as the unpadded one."""
    dims = v.dim() if dims is None else dims
    lead = v.shape[:v.dim() - dims]
    grid = v.to(f32).reshape(-1, *((1, v.shape[-1]) if dims == 1
                                   else v.shape[-2:]))
    return seq_sum_ops.seq_sum(grid).reshape(lead)


def block_bits(qcoefs, block_mask=None):
    """Each block's share of :func:`entropy_bits` (without the 4-bit
    per-block overhead): (..., nb, 8, 8) -> (..., nb), zero where
    ``block_mask`` ((..., nb) bool) is False."""
    a = qcoefs.abs()
    bits = torch.where(a > 0, 2.0 * torch.log2(1.0 + a) + 1.0, 0.0)
    per_block = bits.sum(dim=(-2, -1))          # a fixed (8, 8) tile reduce
    if block_mask is not None:
        per_block = torch.where(block_mask, per_block, 0.0)
    return per_block


def entropy_bits(qcoefs, block_mask=None, n_blocks=None, grid=None):
    """Bit-cost proxy: 2*log2(1+|q|)+1 per nonzero coefficient plus 4 bits
    per block.  qcoefs: (..., nb, 8, 8) -> (...); ``grid`` is the frame's
    (block_rows, block_cols) 8x8 block grid.  ``block_mask`` ((..., nb)
    bool) with ``n_blocks`` (the valid blocks' count, a number or a (...)
    tensor) charges only the valid blocks of a padded frame."""
    per_block = block_bits(qcoefs, block_mask)
    if block_mask is not None:
        overhead = torch.as_tensor(n_blocks, dtype=f32,
                                   device=qcoefs.device) * 4.0
    else:
        overhead = qcoefs.shape[-3] * 4.0
    if grid is not None:
        per_block = per_block.reshape(*per_block.shape[:-1], *grid)
        return seq_sum(per_block, 2) + overhead
    return seq_sum(per_block, 1) + overhead


def transform_quantize(img, quality):
    """JPEG round trip of (H, W) or (T, H, W) frames, all blocks in one
    blockdct launch.  Returns (recon, bits) with bits () or (T,)."""
    H, W = img.shape[-2:]
    q, rec = dct_quantize_raster(img.to(f32) - 128.0,
                                 quant_table(quality, img.device))
    bits = entropy_bits(q, grid=(H // 8, W // 8))
    return (rec + 128.0).clamp(0.0, 255.0), bits
