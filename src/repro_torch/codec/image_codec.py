"""JPEG-like HD image codec for BiSwift anchors, paper §IV-A (port of
``repro.codec.image_codec``: the pinned-quality encode)."""
from __future__ import annotations

import torch

from repro_torch.codec import blockdct as B

f32 = torch.float32

# the discrete anchor-quality ladder of the budget search (not ported yet)
ANCHOR_QUALITY_LADDER = (20.0, 35.0, 50.0, 65.0, 80.0, 92.0)


def jpeg_encode_decode(img, quality):
    """img: (H, W) or (T, H, W) float [0, 255] -> (recon, bits); a batch of
    frames is one blockdct launch."""
    return B.transform_quantize(img, quality)


def psnr(a, b, peak: float = 255.0):
    mse = (a.to(f32) - b.to(f32)).square().mean()
    return 10.0 * torch.log10(peak * peak / mse.clamp(min=1e-9))
