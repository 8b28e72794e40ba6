"""The traffic generator: cameras and their uplink, made from a seed.

A frozen copy of the port's stream renderer (``sim/video_source``:
textured rectangles bouncing over a noisy background, ground-truth boxes
with every frame) and of its link trace (``sim/network.generate_trace``:
log-normal AR(1) levels with drops), with the bitrate ladder's rule
(``codec/rate_model``).  The benchmark owns this copy, so a change to the
program cannot move the yardstick.

A traffic file (``traffic/<name>.json``) holds only parameters:

* ``cameras``: ``{"scaled_from_px": 96, "pattern": [{"name",
  "n_objects", "min_size", "max_size", "speed", "texture_contrast",
  "background_level", "seed"}, ...]}``: camera i takes pattern entry
  i mod its length; object sizes and speeds, stated for
  ``scaled_from_px``-high frames, are scaled to the configuration's frame
  height.  The configuration's ``streams`` says how many cameras there
  are;
* ``uplink``: the one uplink the cameras share, ``{"kind": "constant",
  "kbps": x}`` or ``{"kind": "ar1", "mean_kbps", "std_log", "ar",
  "drop_prob", "drop_factor", "floor_kbps"}``, one value a chunk, split
  evenly over the cameras;
* ``ring_chunks``: distinct seconds of video rendered at set-up.

Camera i's seed is ``seed * 1000 + (its entry's seed) + i`` and the
uplink's ``seed * 1000 + 300``, so every seed gives other content and
another trace, and the same seed the same ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

f32 = torch.float32
SEED_STRIDE = 1000
TRACE_STEPS = 4096          # uplink values: one a chunk


@dataclasses.dataclass(frozen=True)
class Camera:
    name: str
    height: int
    width: int
    n_objects: int
    min_size: float
    max_size: float
    speed: float                  # px / frame
    texture_contrast: float = 90.0
    background_level: float = 110.0
    seed: int = 0


def cameras(spec: dict, n: int, height: int, width: int, seed: int) -> list:
    """``n`` cameras of the traffic's pattern at (height, width), sizes
    and speeds scaled from ``scaled_from_px``, seeds offset by ``seed``."""
    k = height / spec.get("scaled_from_px", height)
    pattern = spec["pattern"]
    out = []
    for i in range(n):
        p = pattern[i % len(pattern)]
        out.append(Camera(f"{p['name']}_{i}", height, width, p["n_objects"],
                          int(p["min_size"] * k), int(p["max_size"] * k),
                          p["speed"] * k, p["texture_contrast"],
                          p["background_level"],
                          seed * SEED_STRIDE + p["seed"] + i))
    return out


def _object_params(cam: Camera) -> dict:
    """Seed-derived object and background state, drawn on the CPU."""
    g = torch.Generator().manual_seed(cam.seed)
    H, W, N = cam.height, cam.width, cam.n_objects
    pos0 = torch.rand((N, 2), generator=g) * torch.tensor([H, W], dtype=f32)
    vel = (torch.rand((N, 2), generator=g) - 0.5) * 2 * cam.speed
    size = torch.rand((N, 2), generator=g) * (cam.max_size - cam.min_size) \
        + cam.min_size
    tex_phase = torch.rand((N,), generator=g) * 6.28
    yy = torch.linspace(0, 1, H)[:, None]
    xx = torch.linspace(0, 1, W)[None, :]
    base = cam.background_level + 25.0 * torch.sin(6.28 * 2 * xx) \
        + 15.0 * yy
    bg = base + torch.randn((H, W), generator=g) * 4.0
    return dict(pos0=pos0, vel=vel, size=size, tex_phase=tex_phase, bg=bg)


def _render(p: dict, t0: int, n_frames: int, H: int, W: int):
    """Frames (S, T, H, W), boxes (S, T, N, 4) cxcywh px and valid (S, T,
    N) of S cameras' stacked parameters; element-wise in each frame."""
    pos0, vel, size = p["pos0"], p["vel"], p["size"]
    dev = pos0.device
    S, N = pos0.shape[:2]
    t = t0 + torch.arange(n_frames, dtype=f32, device=dev)[None, :, None,
                                                          None]
    span = torch.tensor([H, W], dtype=f32, device=dev) - size
    raw = pos0[:, None] + vel[:, None] * t
    period = 2 * span.clamp(min=1.0)
    tri = (torch.remainder(raw, period[:, None]) - span[:, None]).abs()
    center = tri + size[:, None] / 2
    yy = torch.arange(H, dtype=f32, device=dev)[:, None]
    xx = torch.arange(W, dtype=f32, device=dev)[None, :]
    cy = center[..., 0][..., None, None]
    cx = center[..., 1][..., None, None]
    hh = size[:, None, :, 0, None, None] / 2
    ww = size[:, None, :, 1, None, None] / 2
    inside = ((yy - cy).abs() <= hh) & ((xx - cx).abs() <= ww)
    phase = p["tex_phase"][:, None, :, None, None]
    tex = p["tex_contrast"][:, None, None, None, None] * torch.sign(
        torch.sin(0.8 * yy + phase) * torch.sin(0.8 * xx + phase))
    obj_pix = torch.where(inside, 40.0 + tex.abs(), 0.0)
    frames = (p["bg"][:, None] + obj_pix.amax(dim=2)).clamp(0.0, 255.0)
    boxes = torch.cat([center, size[:, None].expand_as(center)], dim=-1)
    valid = torch.ones((S, n_frames, N), dtype=torch.bool, device=dev)
    return frames, boxes, valid


FRAMES_A_CALL = 6           # frames rendered in one call, for memory


def render_chunk(cams: list, t0: int, n_frames: int, device):
    """One chunk of every camera from frame ``t0``: frames (S, T, H, W),
    ground truth padded to the densest camera's object count (the pad
    invalid).  Cameras of one shape render together, a few frames a
    call."""
    H, W = cams[0].height, cams[0].width
    n_max = max(c.n_objects for c in cams)
    S = len(cams)
    frames = torch.empty((S, n_frames, H, W), dtype=f32, device=device)
    boxes = torch.zeros((S, n_frames, n_max, 4), dtype=f32, device=device)
    valid = torch.zeros((S, n_frames, n_max), dtype=torch.bool,
                        device=device)
    groups: dict = {}
    for i, c in enumerate(cams):
        groups.setdefault(c.n_objects, []).append(i)
    for n, idx in groups.items():
        params = [_object_params(cams[i]) for i in idx]
        p = {k: torch.stack([q[k] for q in params]).to(device)
             for k in params[0]}
        p["tex_contrast"] = torch.tensor(
            [cams[i].texture_contrast for i in idx], dtype=f32,
            device=device)
        ix = torch.tensor(idx, device=device)
        for a in range(0, n_frames, FRAMES_A_CALL):
            m = min(FRAMES_A_CALL, n_frames - a)
            f, b, v = _render(p, t0 + a, m, H, W)
            frames[ix, a:a + m] = f
            boxes[ix, a:a + m, :n] = b
            valid[ix, a:a + m, :n] = v
    return frames, boxes, valid


# ------------------------------------------------------------------ links
def _ar1_path(eps: np.ndarray, ar: float) -> np.ndarray:
    """x_t = ar x_{t-1} + eps_t with x_{-1} = 0, in blocked cumulative
    form."""
    n = eps.size
    if n == 0 or ar == 0.0:
        return eps.astype(np.float64)
    B = int(np.clip(-600.0 / np.log(abs(ar)), 1, 4096))
    out = np.empty(n, np.float64)
    carry = 0.0
    for s in range(0, n, B):
        e = eps[s:s + B].astype(np.float64)
        p = ar ** np.arange(e.size)
        blk = p * np.cumsum(e / p) + carry * ar * p
        out[s:s + e.size] = blk
        carry = blk[-1]
    return out


def link_trace(mean_kbps: float, std_log: float, ar: float,
               drop_prob: float, drop_factor: float, floor_kbps: float,
               seed: int, n_steps: int = TRACE_STEPS) -> np.ndarray:
    """One link's bandwidth a chunk (kbps): log-normal levels around
    ``mean_kbps``, AR(1) in time, transient drops, a floor."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, std_log, n_steps)
    u = rng.random(n_steps)
    x = _ar1_path(eps * np.sqrt(1.0 - ar ** 2), ar)
    bw = mean_kbps * np.exp(x - std_log ** 2 / 2)
    bw = np.where(u < drop_prob, bw * drop_factor, bw)
    return np.maximum(bw, floor_kbps)


def links(uplink: dict, n_streams: int, seed: int) -> np.ndarray:
    """(TRACE_STEPS, n_streams) kbps, a row a chunk: the shared uplink
    split evenly over the streams."""
    if uplink["kind"] == "constant":
        total = np.full(TRACE_STEPS, float(uplink["kbps"]))
    elif uplink["kind"] == "ar1":
        total = link_trace(uplink["mean_kbps"], uplink["std_log"],
                           uplink["ar"], uplink["drop_prob"],
                           uplink["drop_factor"], uplink["floor_kbps"],
                           seed * SEED_STRIDE + 300)
    else:
        raise ValueError(f"unknown uplink kind {uplink['kind']!r}")
    return np.repeat(total[:, None] / n_streams, n_streams, axis=1)


# ------------------------------------------------------- the ladder's rule
# (bitrate kbps, scale, codec quality) of the five rungs of §VI-A
LADDER = ((500.0, 0.25, 30.0), (1000.0, 1 / 3, 40.0), (1500.0, 0.5, 50.0),
          (2000.0, 2 / 3, 65.0), (5000.0, 1.0, 80.0))
ANCHOR_HEADROOM = 0.65      # the share of a link the video may spend


def rung_for_link(kbps: float, headroom: float = 0.95) -> int:
    """The highest rung whose bitrate fits the video's share of the link
    (the encoder follows the bandwidth it is given, §IV-A)."""
    level = 0
    for i, (rate, _, _) in enumerate(LADDER):
        if rate <= kbps * ANCHOR_HEADROOM * headroom:
            level = i
    return level


def lr_shape(level: int, H: int, W: int) -> tuple[int, int]:
    """The multiple-of-16 LR shape of a rung for an (H, W) source."""
    scale = LADDER[level][1]
    return max(int(H * scale) // 16 * 16, 16), max(int(W * scale) // 16 * 16,
                                                   16)


def downscale(frames, level: int):
    """(T, H, W) average-pooled to the rung's LR shape."""
    T, H, W = frames.shape
    h, w = lr_shape(level, H, W)
    fy, fx = H // h, W // w
    return frames[:, :fy * h, :fx * w].reshape(T, h, fy, w, fx).mean(
        dim=(2, 4))
