"""The 5-level quality ladder of §VI-A, the bandwidth -> rung selection,
ladder shapes, and the down/up scalers (port of
``repro.codec.rate_model``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import host_to_device


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


# fraction of a stream's allocation the video encoder may spend; the rest
# is headroom reserved for the JPEG anchors (§IV-A)
ANCHOR_HEADROOM = 0.65


def video_bandwidth_share(bw_kbps: float) -> float:
    """The bandwidth the ladder selection sees after anchor headroom."""
    return bw_kbps * ANCHOR_HEADROOM


def ladder_for_bandwidth(bw_kbps: float, headroom: float = 0.95) -> int:
    """Highest ladder level whose bitrate fits within bw_kbps * headroom:
    the encoder follows the bandwidth the controller allocated (§IV-A)."""
    level = 0
    for i, ql in enumerate(QUALITY_LADDER):
        if ql.bitrate_kbps <= bw_kbps * headroom:
            level = i
    return level


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
    """(..., h, w) -> (..., H, W) nearest-neighbour, index-mapped so
    non-integer factors work exactly: one gather.  ``src_hw`` overrides
    the source extent when ``frames`` carries a margin beyond the valid
    region: one (h, w), or an (S, 2) tensor of them, one a stream of a
    leading stream axis (a mixed-ladder padded canvas)."""
    dev = frames.device
    hc, wc = frames.shape[-2:]
    ext = host_to_device((hc, wc) if src_hw is None else src_hw,
                         dev).long().reshape(-1, 2)
    S = ext.shape[0]
    h, w = ext[:, 0:1], ext[:, 1:2]                       # (S, 1)
    yi = torch.minimum(torch.arange(H, device=dev)[None] * h // H, h - 1)
    xi = torch.minimum(torch.arange(W, device=dev)[None] * w // W, w - 1)
    x = frames.reshape(S, -1, hc * wc)
    idx = (yi[:, :, None] * wc + xi[:, None, :]).reshape(S, 1, H * W)
    return x.gather(2, idx.expand(S, x.shape[1], H * W)).reshape(
        *frames.shape[:-2], H, W)
