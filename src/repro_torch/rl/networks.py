"""DRL networks sized as the paper's §VI-B (port of ``repro.rl.networks``).

Low level (per camera, actor-critic): policy and value both 2-layer MLPs
of 128 units, ReLU.  High level (bandwidth controller, SAC): policy a
4-layer MLP of 256 units; value and Q 3-layer MLPs of 256 units, ReLU.

Parameters are nested dicts of f32 tensors, one agent or a stack of
agents on leading axes (the C per-camera agents of the bi-level control
plane).  The dense layer is the reference's broadcast-multiply and sum,
``(x[..., :, None] * w).sum(-2) + b``, not ``x @ w``: a matmul picks its
accumulation order by its batch count, and this form sums each output
in one order whatever the leading axes, so a stream's lane of a stack is
computed as the stream alone.  These MLPs are far too small for a GEMM
to matter.

The squashed-Gaussian helpers take their standard normal draws as a
tensor, ``eps``, drawn by the caller (``repro_torch.core.bilevel``).

The transcendental functions go through :func:`f64`: PyTorch's CPU
kernels evaluate them with SIMD code in the body of a tensor and with
libm in its tail, which may differ in the last bit, so that a stream's
lane would depend on its place in the stack.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.params import init_params, spec

f32 = torch.float32
HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def f64(fn, x):
    """``fn(x)`` evaluated in float64 and rounded to float32.  The SIMD
    and the libm float64 values differ by an f64 ulp at most, so their
    f32 roundings agree but for a value within that ulp of an f32
    rounding boundary: a lane's result no longer depends on its place in
    the tensor."""
    return fn(x.double()).float()


def leaf_params(params: dict) -> dict:
    """Detached copies of a net's tensors that require grad."""
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def grad(loss, params: dict) -> dict:
    """d loss / d params by ``torch.autograd.grad``; over a stack, each
    agent's own loss summed (the agents share no parameter, so each gets
    its own gradient)."""
    keys = list(params)
    grads = torch.autograd.grad(loss.sum(), [params[k] for k in keys])
    return dict(zip(keys, grads))


def mlp_specs(sizes) -> dict:
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"w{i}"] = spec((a, b), (None, None), dtype=f32, init="fan_in")
        p[f"b{i}"] = spec((b,), (None,), dtype=f32, init="zeros")
    return p


def init_mlp(generator: torch.Generator, specs: dict, device) -> dict:
    """Parameters drawn on the CPU from ``generator`` (N(0, 1/fan_in)
    weights, zero biases), then moved to ``device``."""
    return {k: v.to(device) for k, v in
            init_params(generator, specs, "cpu").items()}


def dense(x, w, b):
    """Batch-count-stable dense layer (see the module docstring).  ``w``
    (*stack, a, b) and ``b`` (*stack, b) may carry a stack of agents on
    leading axes; ``x`` is then (*stack, *batch, a)."""
    extra = x.dim() - w.dim() + 1        # x's batch axes after the stack
    if extra > 0:
        w = w.reshape(w.shape[:-2] + (1,) * extra + w.shape[-2:])
        b = b.reshape(b.shape[:-1] + (1,) * extra + b.shape[-1:])
    return (x[..., :, None] * w).sum(-2) + b


def mlp_apply(params, x, n_layers: int):
    for i in range(n_layers):
        x = dense(x, params[f"w{i}"], params[f"b{i}"])
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


# ---------------- low level (paper: 2x128) ----------------
def low_actor_specs(state_dim: int, action_dim: int = 2) -> dict:
    # outputs the mean and log_std of each action dim
    return mlp_specs((state_dim, 128, 128, 2 * action_dim))


def low_critic_specs(state_dim: int) -> dict:
    return mlp_specs((state_dim, 128, 128, 1))


def low_actor_apply(params, state):
    mu, log_std = mlp_apply(params, state, 3).chunk(2, dim=-1)
    # a bounded mean keeps the squashed policy off the tanh saturation
    return mu.clamp(-3.0, 3.0), log_std.clamp(-4.0, 1.0)


def low_critic_apply(params, state):
    return mlp_apply(params, state, 3)[..., 0]


# ---------------- high level (paper: SAC, 4x256 policy / 3x256 value) -----
def high_actor_specs(state_dim: int, action_dim: int) -> dict:
    return mlp_specs((state_dim, 256, 256, 256, 256, 2 * action_dim))


def high_value_specs(state_dim: int) -> dict:
    return mlp_specs((state_dim, 256, 256, 256, 1))


def high_q_specs(state_dim: int, action_dim: int) -> dict:
    return mlp_specs((state_dim + action_dim, 256, 256, 256, 1))


def high_actor_apply(params, state):
    mu, log_std = mlp_apply(params, state, 5).chunk(2, dim=-1)
    return mu, log_std.clamp(-5.0, 2.0)


def high_value_apply(params, state):
    return mlp_apply(params, state, 4)[..., 0]


def high_q_apply(params, state, action):
    return mlp_apply(params, torch.cat([state, action], -1), 4)[..., 0]


# ---------------- squashed-Gaussian helpers ----------------
def sample_squashed(eps, mu, log_std):
    """tanh-squashed Gaussian -> (action in (0, 1), log-prob), from the
    standard normal draws ``eps`` (the shape of ``mu``)."""
    std = f64(torch.exp, log_std)
    tanh = f64(torch.tanh, mu + std * eps)
    a = 0.5 * (tanh + 1.0)
    logp = (-0.5 * (eps ** 2) - log_std - HALF_LOG_2PI).sum(-1)
    # tanh + affine change of variables
    logp = logp - f64(torch.log, 0.5 * (1 - tanh ** 2) + 1e-6).sum(-1)
    return a, logp


def deterministic_action(mu):
    return 0.5 * (f64(torch.tanh, mu) + 1.0)


def policy_action(eps, mu, log_std, explore: bool):
    """Squashed-Gaussian action in (0, 1): sampled from ``eps`` or
    deterministic.  Both the A2C and the SAC act route through here."""
    if explore:
        return sample_squashed(eps, mu, log_std)[0]
    return deterministic_action(mu)
