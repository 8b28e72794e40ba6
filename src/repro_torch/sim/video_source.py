"""Synthetic surveillance-style video sources (port of
``repro.sim.video_source``).

Textured rectangles bounce over a structured, noisy background; ground
truth boxes come with every frame.  The draws come from the port's own
``torch.Generator`` seeded by ``cfg.seed``, so the frames follow the
reference's distributions, not its exact values.  ``paper_stream_mix``
and ``scenario_streams`` are the reference's stream sets, field for field;
``generate_chunk_batched`` renders the streams of one shape signature at
once, each lane bit for bit its ``generate_chunk``.
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

    @property
    def max_objects(self) -> int:
        return self.n_objects

    @property
    def batch_signature(self) -> tuple:
        """Streams with equal signatures render with identical shapes and
        share one ``generate_chunk_batched`` call."""
        return (self.height, self.width, self.n_objects)


def paper_stream_mix(n_streams: int, height: int = 96, width: int = 160):
    """The paper's heterogeneous mix (Fig. 3d / Fig. 10): even streams
    large, sparse and slow; odd ones small, dense and fast."""
    mix = []
    for i in range(n_streams):
        if i % 2 == 0:
            mix.append(StreamConfig(name=f"sparse_{i}", height=height,
                                    width=width, n_objects=3, min_size=20,
                                    max_size=32, speed=1.5, seed=100 + i))
        else:
            mix.append(StreamConfig(name=f"dense_{i}", height=height,
                                    width=width, n_objects=12, min_size=10,
                                    max_size=16, speed=3.0, seed=200 + i))
    return mix


def scenario_streams(scenario: str, n_streams: int = 1, height: int = 96,
                     width: int = 160) -> list[StreamConfig]:
    """Named content scenarios of the ROI benchmarks: ``sparse-highway``
    (a couple of large fast objects on a bright background),
    ``crowded-crossroad`` (many small slow objects everywhere) and
    ``day-night-mix`` (bright and low-light streams in turns)."""
    if scenario == "sparse-highway":
        return [StreamConfig(name=f"highway_{i}", height=height,
                             width=width, n_objects=2, min_size=18,
                             max_size=30, speed=4.0, texture_contrast=80.0,
                             background_level=150.0, seed=300 + i)
                for i in range(n_streams)]
    if scenario == "crowded-crossroad":
        return [StreamConfig(name=f"crossroad_{i}", height=height,
                             width=width, n_objects=14, min_size=8,
                             max_size=14, speed=1.5, texture_contrast=70.0,
                             background_level=110.0, seed=400 + i)
                for i in range(n_streams)]
    if scenario == "day-night-mix":
        return [StreamConfig(
            name=f"{'day' if i % 2 == 0 else 'night'}_{i}", height=height,
            width=width, n_objects=6, min_size=10, max_size=20, speed=2.0,
            texture_contrast=90.0 if i % 2 == 0 else 40.0,
            background_level=120.0 if i % 2 == 0 else 35.0, seed=500 + i)
            for i in range(n_streams)]
    raise ValueError(
        f"unknown scenario {scenario!r} (expected 'sparse-highway', "
        "'crowded-crossroad' or 'day-night-mix')")


def group_by_signature(cfgs) -> dict:
    """Stream indices grouped by ``batch_signature``, in first-seen order:
    each group renders and round-trips as one batch."""
    groups: dict = {}
    for i, sc in enumerate(cfgs):
        groups.setdefault(sc.batch_signature, []).append(i)
    return groups


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


def _render(p: dict, t0: int, n_frames: int, H: int, W: int):
    """The renderer of S streams' stacked parameters (each (S, ...)):
    (frames (S, T, H, W), boxes (S, T, N, 4), valid (S, T, N)).  Every
    operation is element-wise or a max over the objects, so a stream's
    lane does not depend on the others."""
    pos0, vel, size = p["pos0"], p["vel"], p["size"]
    dev = pos0.device
    S, N = pos0.shape[:2]
    t = t0 + torch.arange(n_frames, dtype=f32, device=dev)[None, :, None,
                                                          None]
    # positions bounce off the walls as a triangular wave
    span = torch.tensor([H, W], dtype=f32, device=dev) - size   # (S, N, 2)
    raw = pos0[:, None] + vel[:, None] * t                      # (S, T, N, 2)
    period = 2 * span.clamp(min=1.0)
    tri = (torch.remainder(raw, period[:, None]) - span[:, None]).abs()
    center = tri + size[:, None] / 2                            # (S, T, N, 2)

    yy = torch.arange(H, dtype=f32, device=dev)[:, None]
    xx = torch.arange(W, dtype=f32, device=dev)[None, :]
    cy = center[..., 0][..., None, None]
    cx = center[..., 1][..., None, None]
    hh = size[:, None, :, 0, None, None] / 2
    ww = size[:, None, :, 1, None, None] / 2
    inside = ((yy - cy).abs() <= hh) & ((xx - cx).abs() <= ww)  # (S,T,N,H,W)
    phase = p["tex_phase"][:, None, :, None, None]
    tex = p["tex_contrast"][:, None, None, None, None] * torch.sign(
        torch.sin(0.8 * yy + phase) * torch.sin(0.8 * xx + phase))
    obj_pix = torch.where(inside, 40.0 + tex.abs(), 0.0)
    frames = (p["bg"][:, None] + obj_pix.amax(dim=2)).clamp(0.0, 255.0)
    boxes = torch.cat([center, size[:, None].expand_as(center)], dim=-1)
    valid = torch.ones((S, n_frames, N), dtype=torch.bool, device=dev)
    return frames, boxes, valid


def _stacked_params(cfgs, dev) -> dict:
    params = [_object_params(cfg) for cfg in cfgs]
    out = {k: torch.stack([p[k] for p in params]).to(dev) for k in params[0]}
    out["tex_contrast"] = torch.tensor([cfg.texture_contrast for cfg in cfgs],
                                       dtype=f32, device=dev)
    return out


def generate_chunk(cfg: StreamConfig, t0: int, n_frames: int, *,
                   device=None):
    """Returns (frames (T,H,W) [0..255], boxes (T,N,4) cxcywh px,
    valid (T,N)) on the resolved device.  Deterministic in
    (cfg.seed, t0), so consecutive chunks are continuous."""
    frames, boxes, valid = generate_chunk_batched([cfg], t0, n_frames,
                                                  device=device)
    return frames[0], boxes[0], valid[0]


def stacked_params(cfgs, *, device=None) -> dict:
    """The seed-derived object and background state of S streams sharing
    one ``batch_signature``, stacked on the resolved device: what
    ``render_stacked`` draws any chunk of those streams from."""
    sigs = {cfg.batch_signature for cfg in cfgs}
    if len(sigs) != 1:
        raise ValueError(
            f"generate_chunk_batched needs one shape signature, got {sigs}; "
            "group heterogeneous stream mixes by cfg.batch_signature")
    return _stacked_params(cfgs, resolve_device(device))


def render_stacked(params: dict, t0: int, n_frames: int):
    """(frames (S, T, H, W), boxes (S, T, N, 4), valid (S, T, N)) of the
    streams of ``stacked_params`` from frame ``t0``, on their device."""
    H, W = params["bg"].shape[-2:]
    return _render(params, t0, n_frames, H, W)


def generate_chunk_batched(cfgs, t0: int, n_frames: int, *, device=None):
    """Render S streams sharing one ``batch_signature`` (height, width,
    n_objects) at once: (frames (S, T, H, W), boxes (S, T, N, 4), valid
    (S, T, N)) on the resolved device, each lane bit for bit its
    ``generate_chunk``.  Group a mixed set with ``group_by_signature``
    first."""
    return render_stacked(stacked_params(cfgs, device=device), t0, n_frames)
