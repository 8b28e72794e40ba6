"""Synthetic surveillance-style video sources (port of
``repro.sim.video_source``: ``StreamConfig`` and ``generate_chunk``).

Textured rectangles bounce over a structured, noisy background; ground
truth boxes come with every frame.  The draws come from the port's own
``torch.Generator`` seeded by ``cfg.seed``, so the frames follow the
reference's distributions, not its exact values.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    name: str = "stream"
    height: int = 96
    width: int = 160
    n_objects: int = 4
    min_size: int = 12
    max_size: int = 28
    speed: float = 2.0            # px / frame
    texture_contrast: float = 90.0
    background_level: float = 110.0
    seed: int = 0


def _object_params(cfg: StreamConfig) -> dict:
    """Seed-derived object and background state, drawn on the CPU."""
    g = torch.Generator().manual_seed(cfg.seed)
    H, W, N = cfg.height, cfg.width, cfg.n_objects
    pos0 = torch.rand((N, 2), generator=g) * torch.tensor([H, W], dtype=f32)
    vel = (torch.rand((N, 2), generator=g) - 0.5) * 2 * cfg.speed
    size = torch.rand((N, 2), generator=g) * (cfg.max_size - cfg.min_size) \
        + cfg.min_size
    tex_phase = torch.rand((N,), generator=g) * 6.28
    yy = torch.linspace(0, 1, H)[:, None]
    xx = torch.linspace(0, 1, W)[None, :]
    base = cfg.background_level + 25.0 * torch.sin(6.28 * 2 * xx) \
        + 15.0 * yy
    bg = base + torch.randn((H, W), generator=g) * 4.0
    return dict(pos0=pos0, vel=vel, size=size, tex_phase=tex_phase, bg=bg)


def generate_chunk(cfg: StreamConfig, t0: int, n_frames: int, *,
                   device=None):
    """Returns (frames (T,H,W) [0..255], boxes (T,N,4) cxcywh px,
    valid (T,N)) on the resolved device.  Deterministic in
    (cfg.seed, t0), so consecutive chunks are continuous."""
    dev = resolve_device(device)
    p = {k: v.to(dev) for k, v in _object_params(cfg).items()}
    H, W = cfg.height, cfg.width
    pos0, vel, size, tex_phase = p["pos0"], p["vel"], p["size"], p["tex_phase"]
    t = t0 + torch.arange(n_frames, dtype=f32, device=dev)[:, None, None]
    # positions bounce off the walls as a triangular wave
    span = torch.tensor([H, W], dtype=f32, device=dev) - size    # (N, 2)
    raw = pos0[None] + vel[None] * t                             # (T, N, 2)
    period = 2 * span.clamp(min=1.0)
    tri = (torch.remainder(raw, period[None]) - span[None]).abs()
    center = tri + size[None] / 2                                # (T, N, 2)

    yy = torch.arange(H, dtype=f32, device=dev)[None, None, :, None]
    xx = torch.arange(W, dtype=f32, device=dev)[None, None, None, :]
    cy = center[..., 0][:, :, None, None]
    cx = center[..., 1][:, :, None, None]
    hh = size[None, :, 0, None, None] / 2
    ww = size[None, :, 1, None, None] / 2
    inside = ((yy - cy).abs() <= hh) & ((xx - cx).abs() <= ww)  # (T,N,H,W)
    phase = tex_phase[None, :, None, None]
    tex = cfg.texture_contrast * torch.sign(
        torch.sin(0.8 * yy + phase) * torch.sin(0.8 * xx + phase))
    obj_pix = torch.where(inside, 40.0 + tex.abs(), 0.0)
    frames = (p["bg"][None] + obj_pix.amax(dim=1)).clamp(0.0, 255.0)
    boxes = torch.cat([center, size[None].expand_as(center)], dim=-1)
    valid = torch.ones((n_frames, cfg.n_objects), dtype=torch.bool,
                       device=dev)
    return frames, boxes, valid
