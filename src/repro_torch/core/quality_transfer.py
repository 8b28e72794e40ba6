"""Quality transfer, paper §IV-B Fig. 7 (port of
``repro.core.quality_transfer``): gather each macroblock of the nearest HD
anchor at its accumulated motion vector, add the decoded residual, clip.
Both steps run as kernels on CUDA: the residual's inverse transform is the
``blockdct`` inverse, the gather + add + clip is ``qtransfer``."""
from __future__ import annotations

import torch

from repro_torch.codec import blockdct as B
from repro_torch.kernels.qtransfer.ops import qtransfer


def residual_to_pixels(residual_q, qtab, H: int, W: int):
    """Dequantize + inverse-transform residual coefficients:
    (..., nb, 8, 8) -> (..., H, W), one blockdct inverse launch for every
    frame.  qtab: (8, 8), or tables broadcast over the leading axes, as
    (S, 1, 8, 8) for one a stream of (S, T, nb, 8, 8) coefficients."""
    return B.dequant_idct_raster(residual_q, qtab, H, W)


def transfer_frame(anchor_hd, mv_acc, residual_px):
    """Quality transfer of one frame (H, W) or a batch (T, H, W) in one
    qtransfer launch: anchor_hd the decoded HD anchor, mv_acc
    (..., nby, nbx, 2) anchor-relative MVs, residual_px the decoded
    residual.  Returns clip(warp_blocks(anchor, mv) + residual, 0, 255)."""
    if anchor_hd.dim() == 2:
        return transfer_frame(anchor_hd[None], mv_acc[None],
                              residual_px[None])[0]
    return qtransfer(anchor_hd.contiguous(),
                     mv_acc.to(torch.int32).contiguous(),
                     residual_px.contiguous(), edge="pixel")
