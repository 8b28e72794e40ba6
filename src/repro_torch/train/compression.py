"""Gradient compression with error feedback (port of
``repro.train.compression``).

Two composable schemes, applied before a data-parallel gradient
reduction:

  * top-k sparsification: keep every |g| at or above the k-th largest
    (ties keep more, as ``lax.top_k``'s threshold does), the rest go into
    the error buffer;
  * int8 quantisation: one scale a tensor, round half to even, the
    residual into the error buffer.

Same operations in the same f32 order as the reference, so the results
are equal bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import tree_leaves, tree_map

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"        # none | topk | int8 | topk_int8
    topk_fraction: float = 0.05


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                          device=p.device), params)


def _topk_mask(g, fraction: float):
    k = max(int(g.numel() * fraction), 1)
    thresh = torch.topk(g.reshape(-1).abs(), k).values[-1]
    return (g.abs() >= thresh).to(g.dtype)


def compress(cfg: CompressionConfig, grads, error):
    """Returns (compressed_grads, new_error).  Call before the reduction."""
    if cfg.scheme == "none":
        return grads, error

    def one(g, e):
        g = g.to(f32) + e
        out = g
        if "topk" in cfg.scheme:
            out = g * _topk_mask(g, cfg.topk_fraction)
        if "int8" in cfg.scheme:
            scale = torch.clamp(out.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(out / scale), -127, 127)
            out = q * scale
        return out, g - out

    pairs = tree_map(one, grads, error)
    return (tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs))


def compressed_bytes(cfg: CompressionConfig, grads) -> int:
    """Wire bytes: values, plus indices for top-k, plus a scale for int8."""
    total = 0
    for g in tree_leaves(grads):
        n = g.numel()
        if cfg.scheme == "none":
            total += n * 4
        elif cfg.scheme == "topk":
            k = max(int(n * cfg.topk_fraction), 1)
            total += k * (4 + 4)
        elif cfg.scheme == "int8":
            total += n * 1 + 4
        elif cfg.scheme == "topk_int8":
            k = max(int(n * cfg.topk_fraction), 1)
            total += k * (1 + 4) + 4
    return total
