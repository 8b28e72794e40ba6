"""JPEG-like HD image codec for BiSwift anchors, paper §IV-A (port of
``repro.codec.image_codec``): the pinned-quality encode and the anchor
budget search over ``ANCHOR_QUALITY_LADDER``.

Every function takes one (H, W) image or a batch (..., H, W).  The budget
search charges each rung's bits with one blockdct launch a rung over all
the frames, picks each frame's rung with :func:`budget_rung` (one
expression for the host probe and the fused search), and reconstructs a
frame only at its chosen rung: the reference's sweep of every rung's
reconstruction (:func:`ladder_sweep`) is kept for its own callers.  A
rung's bits are those of ``jpeg_encode_decode`` at that quality, operation
for operation.
"""
from __future__ import annotations

import torch

from repro_torch.codec import blockdct as B

f32 = torch.float32

# the discrete anchor-quality ladder the budget search evaluates
ANCHOR_QUALITY_LADDER = (20.0, 35.0, 50.0, 65.0, 80.0, 92.0)


def jpeg_encode_decode(img, quality):
    """img: (H, W) or (..., H, W) float [0, 255] -> (recon, bits); a batch
    of frames is one blockdct launch."""
    return B.transform_quantize(img, quality)


def jpeg_bits(img, quality):
    """The bits of ``jpeg_encode_decode(img, quality)``: (...)."""
    H, W = img.shape[-2:]
    q, _ = B.dct_quantize_raster(img.to(f32) - 128.0,
                                 B.quant_table(quality, img.device))
    return B.entropy_bits(q, grid=(H // 8, W // 8))


def psnr(a, b, peak: float = 255.0):
    mse = (a.to(f32) - b.to(f32)).square().mean()
    return 10.0 * torch.log10(peak * peak / mse.clamp(min=1e-9))


def ladder_bits(img, qualities=ANCHOR_QUALITY_LADDER):
    """(..., Q) bit cost of every frame at every ladder rung: one blockdct
    launch a rung over all the frames.  Rung q's value is
    ``jpeg_bits(img, qualities[q])``."""
    return torch.stack([jpeg_bits(img, q) for q in qualities], dim=-1)


def ladder_sweep(img, qualities=ANCHOR_QUALITY_LADDER):
    """Encode ``img`` at every ladder rung: (recons (..., Q, H, W), bits
    (..., Q)); rung q is ``jpeg_encode_decode(img, qualities[q])``."""
    recs, bits = zip(*(B.transform_quantize(img, q) for q in qualities))
    return torch.stack(recs, dim=-3), torch.stack(bits, dim=-1)


def budget_rung(bits, bit_budget, qualities=ANCHOR_QUALITY_LADDER):
    """Index of the highest rung whose bit cost fits the budget, over the
    LAST axis of ``bits`` (0 when none fits: the cheapest rung ships
    regardless).  ``bit_budget`` broadcasts against ``bits[..., 0]``."""
    qs = torch.tensor(qualities, dtype=f32, device=bits.device)
    budget = torch.as_tensor(bit_budget, dtype=f32, device=bits.device)
    ok = bits <= budget[..., None]
    best = torch.argmax(torch.where(ok, qs, -1.0), dim=-1)
    return torch.where(ok.any(dim=-1), best, 0)


def quality_for_budget(img, bit_budget, qualities=ANCHOR_QUALITY_LADDER):
    """(quality, bits) of the highest rung whose bit cost fits the budget,
    for each frame of ``img`` ((..., H, W) -> (...), (...)): the
    camera-side adaptation of §IV-A, one blockdct launch a rung."""
    bits = ladder_bits(img, qualities)
    idx = budget_rung(bits, bit_budget, qualities)
    qs = torch.tensor(qualities, dtype=f32, device=bits.device)
    return qs[idx], bits.gather(-1, idx[..., None])[..., 0]
