"""Quality transfer, paper §IV-B Fig. 7 (port of
``repro.core.quality_transfer``): gather each macroblock of the nearest HD
anchor at its accumulated motion vector, add the decoded residual, clip.
Both steps run as kernels on CUDA: the residual's inverse transform is the
``blockdct`` inverse, the gather + add + clip is ``qtransfer``."""
from __future__ import annotations

import torch

from repro_torch.codec import blockdct as B
from repro_torch.codec.motion import accumulate_mv
from repro_torch.kernels.qtransfer.ops import qtransfer

f32 = torch.float32


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


def transfer_chunk(frames_lr_up, anchor_hd, anchor_idx, mvs, residual_q,
                   qtab, types):
    """Quality transfer of every type-2 frame of a chunk.

    frames_lr_up: (T, H, W) decoder-upscaled LR frames (the fallback
    content); anchor_hd: (T, H, W) each frame's nearest-anchor HD plane;
    anchor_idx: (T,) that anchor's index; mvs: (T, nby, nbx, 2)
    frame-to-previous MVs; residual_q: (T, nblocks, 8, 8) residual
    coefficients of the (H, W) grid; qtab: (8, 8); types: (T,).  The
    residuals take one blockdct inverse launch and the transfer one
    qtransfer launch for all T frames.  Returns (T, H, W): the transferred
    frame where types == 2, else ``frames_lr_up``'s."""
    T, H, W = frames_lr_up.shape
    cum = accumulate_mv(mvs)
    mv_rel = cum - cum[torch.as_tensor(anchor_idx,
                                       device=cum.device).long()]
    enhanced = transfer_frame(anchor_hd, mv_rel,
                              residual_to_pixels(residual_q, qtab, H, W))
    types = torch.as_tensor(types, device=frames_lr_up.device)
    return torch.where((types == 2)[:, None, None], enhanced, frames_lr_up)


def transfer_gain_psnr(raw, lr_up, enhanced):
    """PSNR gain of the transfer over the plain upscale (paper Fig. 8a),
    in dB."""
    def p(a, b):
        mse = (a.to(f32) - b.to(f32)).square().mean()
        return 10.0 * torch.log10(255.0 ** 2 / mse.clamp(min=1e-9))
    return p(raw, enhanced) - p(raw, lr_up)
