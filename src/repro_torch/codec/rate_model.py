"""The 5-level quality ladder of §VI-A, ladder shapes, and the down/up
scalers (port of ``repro.codec.rate_model``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QualityLevel:
    name: str
    bitrate_kbps: float
    scale: float          # fraction of raw resolution
    quality: float        # codec quality factor


QUALITY_LADDER = (
    QualityLevel("270p", 500.0, 0.25, 30.0),
    QualityLevel("360p", 1000.0, 1 / 3, 40.0),
    QualityLevel("540p", 1500.0, 0.5, 50.0),
    QualityLevel("720p", 2000.0, 2 / 3, 65.0),
    QualityLevel("1080p", 5000.0, 1.0, 80.0),
)


def lr_shape_for_scale(scale: float, H: int, W: int) -> tuple[int, int]:
    """The multiple-of-16 (h, w) a ``scale`` fraction of (H, W) rounds to."""
    h = max(int(H * scale) // 16 * 16, 16)
    w = max(int(W * scale) // 16 * 16, 16)
    return h, w


def ladder_lr_shape(level: int, H: int, W: int) -> tuple[int, int]:
    """The (h, w) LR shape ``downscale`` produces for a ladder rung."""
    return lr_shape_for_scale(QUALITY_LADDER[level].scale, H, W)


def downscale(frames, scale: float):
    """(T, H, W) average-pool downscale to a multiple-of-16 size (the
    source is cropped to a whole number of pooling windows first)."""
    T, H, W = frames.shape
    h, w = lr_shape_for_scale(scale, H, W)
    fy, fx = H // h, W // w
    x = frames[:, :fy * h, :fx * w].reshape(T, h, fy, w, fx)
    return x.mean(dim=(2, 4))


def upscale_nearest(frames, H: int, W: int, src_hw=None):
    """(T, h, w) -> (T, H, W) nearest-neighbour, index-mapped so
    non-integer factors work exactly.  ``src_hw`` ((h, w)) overrides the
    source extent when ``frames`` carries a margin beyond the valid
    region."""
    h, w = frames.shape[1:] if src_hw is None else src_hw
    dev = frames.device
    yi = (torch.arange(H, device=dev) * h // H).clamp(0, h - 1)
    xi = (torch.arange(W, device=dev) * w // W).clamp(0, w - 1)
    return frames[:, yi][:, :, xi]
