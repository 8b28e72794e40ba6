"""AdamW with global-norm clipping (port of ``repro.train.optimizer``).

Parameters, gradients and moments are nested dicts of tensors.  The state
may hold one agent or a stack of agents on leading axes: ``step`` then
has the stack's shape, and the norm, the clip scale and the learning rate
are taken per agent, over every axis but the stack's.  One norm over the
whole stack would clip every agent by the others' gradients.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import tree_leaves, tree_map

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def init_state(params, lead: tuple = ()) -> dict:
    """Zero moments and a zero step; ``lead`` is the shape of the stack
    of agents the parameters carry on their leading axes (none: one)."""
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                                 device=device), params),
            "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                                 device=device), params),
            "step": torch.zeros(lead, dtype=torch.int32, device=device)}


def abstract_state(param_sds) -> dict:
    """The state of :func:`init_state` as storage-free
    ``ShapeDtypeStruct``s (the dry run): f32 moments placed as their
    parameters, and an int32 step."""
    from repro_torch.distributed.mesh import ShapeDtypeStruct

    def f32_like(p):
        return ShapeDtypeStruct(p.shape, f32, p.sharding)

    return {"mu": tree_map(f32_like, param_sds),
            "nu": tree_map(f32_like, param_sds),
            "step": ShapeDtypeStruct((), torch.int32)}


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warm-up, then a cosine decay to ``min_lr_ratio``."""
    step = step.to(f32)
    warm = (step / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    # in float64, rounded: on the CPU a lane's value then does not depend
    # on the stack's size (see repro_torch.rl.networks.f64)
    cos = 0.5 * (1 + torch.cos(math.pi * prog.double()).float())
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree, lead: int = 0):
    """The L2 norm over every leaf, one for each agent of a stack on the
    ``lead`` leading axes; the leaves are summed in sorted-key order."""
    sq = 0
    for g in tree_leaves(tree):
        g2 = g.to(f32).square()
        dims = tuple(range(lead, g2.dim()))
        sq = sq + (g2.sum(dims) if dims else g2)
    return torch.sqrt(sq)


def apply_updates(params, grads, opt_state, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics); nothing is written in
    place.  The stack's leading axes are those of ``opt_state["step"]``."""
    step = opt_state["step"] + 1
    lead = step.dim()
    gnorm = global_norm(grads, lead)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.double()).float()
    b2c = 1 - torch.pow(cfg.b2, step.double()).float()

    def per_agent(x, p):
        # a per-agent scalar broadcast over one leaf of the stack
        return x.reshape(x.shape + (1,) * (p.dim() - lead))

    def upd(p, g, mu, nu):
        g = g.to(f32) * per_agent(scale, p)
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / per_agent(b1c, p)
        nhat = nu / per_agent(b2c, p)
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if p.dim() - lead >= 2:   # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(f32)
        return (p.to(f32) - per_agent(lr, p) * delta).to(p.dtype), mu, nu

    with torch.no_grad():
        out = tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
    new_p, mu, nu = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
    return new_p, {"mu": mu, "nu": nu, "step": step}, {"grad_norm": gnorm,
                                                       "lr": lr}
