"""ResNet-v1.5 (bottleneck): resnet-50 (3-4-6-3) and resnet-152 (3-8-36-3)
(port of ``repro.models.resnet``).

BatchNorm keeps running stats in a separate ``batch_stats`` collection:
the train step normalises by the batch's statistics (f32, the population
variance) and returns the running stats moved by ``bn_momentum``; eval
normalises by the running stats.  Parameters keep the reference's
nesting and layouts: HWIO kernels, and every leaf of a stage's projection
block (``s{i}_proj``) and of its stacked identity blocks (``s{i}_blocks``)
with a leading block axis of 1 or ``n_id``.  The reference scans the
identity blocks under ``jax.checkpoint``; here they are a Python loop,
each block recomputed in the backward (``torch.utils.checkpoint``) under
autograd, and the new stats of a stage's blocks are stacked as the scan
stacks them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.params import (param_count, spec, tree_stack,
                                      tree_unstack)

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    depths: tuple[int, int, int, int]
    width: int = 64
    n_classes: int = 1000
    dtype: str = "bfloat16"
    bn_momentum: float = 0.9

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        return param_count(param_specs(self)["params"])


def _conv_spec(n, kh, kw, cin, cout, dt):
    return spec((n, kh, kw, cin, cout), (None, None, None, None, "tensor"),
                dtype=dt, init="fan_in")


def _bn_specs(n, c):
    return {
        "scale": spec((n, c), (None, None), dtype=f32, init="ones"),
        "bias": spec((n, c), (None, None), dtype=f32, init="zeros"),
    }


def _bn_stats(n, c):
    return {
        "mean": spec((n, c), (None, None), dtype=f32, init="zeros"),
        "var": spec((n, c), (None, None), dtype=f32, init="ones"),
    }


def stage_channels(cfg: ResNetConfig):
    w = cfg.width
    return [(w * (2 ** i), w * (2 ** i) * 4) for i in range(4)]  # (mid, out)


def param_specs(cfg: ResNetConfig) -> dict:
    """``{"params": ..., "batch_stats": ...}``, each a nested dict of
    specs."""
    dt = cfg.torch_dtype
    params = {
        "stem_conv": _conv_spec(1, 7, 7, 3, cfg.width, dt),
        "stem_bn": _bn_specs(1, cfg.width),
        "head_w": spec((cfg.width * 32, cfg.n_classes), ("fsdp", "tensor"),
                       dtype=dt, init="fan_in"),
        "head_b": spec((cfg.n_classes,), ("tensor",), dtype=dt,
                       init="zeros"),
    }
    stats = {"stem_bn": _bn_stats(1, cfg.width)}
    in_c = cfg.width
    for si, (n_blocks, (mid, out)) in enumerate(zip(cfg.depths,
                                                    stage_channels(cfg))):
        # the projection block, first of the stage
        params[f"s{si}_proj"] = {
            "conv0": _conv_spec(1, 1, 1, in_c, mid, dt),
            "bn0": _bn_specs(1, mid),
            "conv1": _conv_spec(1, 3, 3, mid, mid, dt),
            "bn1": _bn_specs(1, mid),
            "conv2": _conv_spec(1, 1, 1, mid, out, dt),
            "bn2": _bn_specs(1, out),
            "convp": _conv_spec(1, 1, 1, in_c, out, dt),
            "bnp": _bn_specs(1, out),
        }
        stats[f"s{si}_proj"] = {
            "bn0": _bn_stats(1, mid), "bn1": _bn_stats(1, mid),
            "bn2": _bn_stats(1, out), "bnp": _bn_stats(1, out),
        }
        # the identity blocks, stacked
        n_id = n_blocks - 1
        if n_id:
            params[f"s{si}_blocks"] = {
                "conv0": _conv_spec(n_id, 1, 1, out, mid, dt),
                "bn0": _bn_specs(n_id, mid),
                "conv1": _conv_spec(n_id, 3, 3, mid, mid, dt),
                "bn1": _bn_specs(n_id, mid),
                "conv2": _conv_spec(n_id, 1, 1, mid, out, dt),
                "bn2": _bn_specs(n_id, out),
            }
            stats[f"s{si}_blocks"] = {
                "bn0": _bn_stats(n_id, mid), "bn1": _bn_stats(n_id, mid),
                "bn2": _bn_stats(n_id, out),
            }
        in_c = out
    return {"params": params, "batch_stats": stats}


def _bn(x, p, stats, train: bool, momentum: float):
    """BatchNorm over (B, H, W) of NHWC x: (y in x's dtype, new stats).
    Training takes the batch's mean and population variance in f32 and
    moves the running stats to ``momentum * old + (1 - momentum) * new``;
    eval takes the running stats and returns them as they are."""
    if train:
        xf = x.float()
        mean = xf.mean(dim=(0, 1, 2))
        var = torch.square(xf - mean).mean(dim=(0, 1, 2))
        new = {
            "mean": momentum * stats["mean"] + (1 - momentum) * mean,
            "var": momentum * stats["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = stats["mean"], stats["var"]
        new = stats
    y = (x.float() - mean) * torch.rsqrt(var + 1e-5)
    y = y * p["scale"] + p["bias"]
    return y.to(x.dtype), new


def _bottleneck(x, p, st, train: bool, momentum: float, stride: int = 1,
                project: bool = False):
    """One bottleneck block (the stride on the 3x3, v1.5); p and st hold
    this block's leaves without the block axis.  Returns (y, new stats)."""
    new_st = {}
    h, new_st["bn0"] = _bn(L.conv_nhwc(x, p["conv0"]), p["bn0"], st["bn0"],
                           train, momentum)
    h = torch.relu(h)
    h, new_st["bn1"] = _bn(L.conv_nhwc(h, p["conv1"], stride=stride),
                           p["bn1"], st["bn1"], train, momentum)
    h = torch.relu(h)
    h, new_st["bn2"] = _bn(L.conv_nhwc(h, p["conv2"]), p["bn2"], st["bn2"],
                           train, momentum)
    if project:
        sc, new_st["bnp"] = _bn(L.conv_nhwc(x, p["convp"], stride=stride),
                                p["bnp"], st["bnp"], train, momentum)
    else:
        sc = x
    return L.constrain(torch.relu(h + sc), "batch", None, None, None), new_st


def forward(variables, cfg: ResNetConfig, images, train: bool = False):
    """images (B, H, W, 3) -> (logits (B, n_classes) f32, new
    batch_stats in the nesting and shapes of ``variables["batch_stats"]``;
    in eval mode ``variables["batch_stats"]`` itself)."""
    p, st = variables["params"], variables["batch_stats"]
    mom = cfg.bn_momentum
    remat = torch.is_grad_enabled()
    new_st = {}          # each collection's per-block stats, in order
    x = images.to(cfg.torch_dtype)
    x = L.conv_nhwc(x, p["stem_conv"][0], stride=2)
    x, s = _bn(x, tree_unstack(p["stem_bn"])[0],
               tree_unstack(st["stem_bn"])[0], train, mom)
    new_st["stem_bn"] = [s]
    x = torch.relu(x)
    x = L.max_pool_nhwc(x, 3, 2)
    for si, n_blocks in enumerate(cfg.depths):
        stride = 1 if si == 0 else 2
        x, s = _bottleneck(x, tree_unstack(p[f"s{si}_proj"])[0],
                           tree_unstack(st[f"s{si}_proj"])[0], train, mom,
                           stride=stride, project=True)
        new_st[f"s{si}_proj"] = [s]
        if n_blocks > 1:
            new_st[f"s{si}_blocks"] = []
            for bp, bs in zip(tree_unstack(p[f"s{si}_blocks"]),
                              tree_unstack(st[f"s{si}_blocks"])):
                if remat:
                    x, s = checkpoint(_bottleneck, x, bp, bs, train, mom,
                                      use_reentrant=False)
                else:
                    x, s = _bottleneck(x, bp, bs, train, mom)
                new_st[f"s{si}_blocks"].append(s)
    x = x.float().mean(dim=(1, 2)).to(cfg.torch_dtype)  # global avg pool
    logits = L.mm_f32(x, p["head_w"]) + p["head_b"].float()
    if not train:
        return logits, st
    return logits, {k: tree_stack(v) for k, v in new_st.items()}


def loss_fn(variables, cfg: ResNetConfig, batch):
    """(mean cross-entropy of ``batch`` {"images", "labels"} in training
    mode, the new batch_stats)."""
    from repro_torch.models.transformer_lm import softmax_xent
    logits, new_st = forward(variables, cfg, batch["images"], train=True)
    return softmax_xent(logits, batch["labels"]), new_st
