"""EDSR-lite super-resolution, the neural-enhancement module of the
AccDecoder / NeuroScaler baselines (port of ``repro.models.sr_edsr``).

Conv -> N residual blocks -> nearest upsample + conv refinement, in f32,
with the reference's HWIO kernels (the blocks stacked on a leading axis).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.params import init_params, spec, tree_unstack

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class EDSRConfig:
    channels: int = 16
    n_blocks: int = 4
    scale: int = 2


def param_specs(cfg: EDSRConfig) -> dict:
    c = cfg.channels
    return {
        "head": spec((3, 3, 1, c), (None, None, None, "tensor"), dtype=f32,
                     init="fan_in"),
        "tail": spec((3, 3, c, 1), (None, None, "tensor", None), dtype=f32,
                     init="fan_in"),
        "blocks": {
            "w1": spec((cfg.n_blocks, 3, 3, c, c),
                       (None, None, None, None, "tensor"), dtype=f32,
                       init="fan_in"),
            "w2": spec((cfg.n_blocks, 3, 3, c, c),
                       (None, None, None, "tensor", None), dtype=f32,
                       init="fan_in"),
        },
    }


def init(generator: torch.Generator, cfg: EDSRConfig, device=None) -> dict:
    """Parameters by the reference's rules, drawn from ``generator`` (which
    must live on the resolved device)."""
    return init_params(generator, param_specs(cfg), resolve_device(device))


def _upsample(x, s: int):
    """Nearest upsample of (B, h, w, ...) by s in h and w."""
    return x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)


def forward(params, cfg: EDSRConfig, frames):
    """frames: (B, h, w) [0..255] -> (B, h*scale, w*scale) f32 in
    [0, 255]."""
    base = frames.float() / 255.0
    x = L.conv_nhwc(base[..., None], params["head"])
    for p in tree_unstack(params["blocks"]):
        h = torch.relu(L.conv_nhwc(x, p["w1"]))
        x = x + 0.1 * L.conv_nhwc(h, p["w2"])
    s = cfg.scale
    x = L.conv_nhwc(_upsample(x, s), params["tail"])[..., 0] \
        + _upsample(base, s)
    return torch.clamp(x * 255.0, 0.0, 255.0)


def loss_fn(params, cfg: EDSRConfig, lr_frames, hd_frames):
    out = forward(params, cfg, lr_frames)
    return torch.mean(torch.square(out - hd_frames.float())) / (255.0 ** 2)
