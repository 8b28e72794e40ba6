"""Carry weights across from the JAX reference: the TinyDetector's, the
decoder LM's, the vision and diffusion zoo's and the control plane's
agents (optimiser state included)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def detector_params_from_jax(params: dict, device=None) -> dict:
    """The reference's TinyDetector params (numpy arrays, HWIO convs) ->
    the port's dict (OIHW convs) on the resolved device.

    ``conv{i}`` (3, 3, cin, c) -> (c, cin, 3, 3); ``head`` (1, 1, cin, 5)
    -> (5, cin, 1, 1); the biases (``bias{i}``, ``head_b``) are kept.
    """
    dev = resolve_device(device)
    out = {}
    for name, value in params.items():
        a = np.array(value, dtype=np.float32)  # a writable copy
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim != 1:
            raise ValueError(f"{name}: expected a 4-D HWIO kernel or a 1-D "
                             f"bias, got shape {a.shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def detector_params_to_jax(params: dict) -> dict:
    """The port's TinyDetector params (OIHW convs) -> the reference's
    layout as host f32 numpy arrays: ``conv{i}`` (c, cin, 3, 3) -> (3, 3,
    cin, c), ``head`` (5, cin, 1, 1) -> (1, 1, cin, 5), the biases kept;
    exact, the inverse of :func:`detector_params_from_jax`.  A detector
    checkpoint written from it restores in either package."""
    out = {}
    for name, value in params.items():
        a = value.detach().to("cpu", torch.float32).numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim != 1:
            raise ValueError(f"{name}: expected a 4-D OIHW kernel or a 1-D "
                             f"bias, got shape {a.shape}")
        out[name] = np.ascontiguousarray(a)
    return out


def lm_params_from_jax(params: dict, device=None) -> dict:
    """The reference's decoder-LM params (nested dict of numpy arrays,
    bf16 or f32) -> the same nesting of bf16 tensors on the resolved
    device, in the reference's layouts (``wq`` (L, d, H, Dh), ``wo`` (L,
    H, Dh, d), ``embed`` (V, d), ...).  bf16 arrays (``ml_dtypes``'
    dtype, which ``torch.from_numpy`` rejects) pass through an f32 copy: exact
    both ways."""
    dev = resolve_device(device)
    return {name: lm_params_from_jax(value, dev) if isinstance(value, dict)
            else torch.from_numpy(np.array(value, np.float32))
            .to(torch.bfloat16).to(dev)
            for name, value in params.items()}


def zoo_params_from_jax(tree: dict, device=None) -> dict:
    """The reference's vision or diffusion parameters (a nested dict of
    numpy arrays: ResNet's ``{"params", "batch_stats"}``, ConvNeXt's, ViT's,
    DiT's or EDSR's tree) -> the same nesting of tensors on the resolved
    device, in the reference's layouts (HWIO kernels, stacked blocks) and
    dtypes: a bf16 leaf (``ml_dtypes``' dtype, which ``torch.from_numpy``
    rejects) passes through an exact f32 copy, the rest keep theirs."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if str(a.dtype) == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)) \
                .to(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return {name: zoo_params_from_jax(value, dev) if isinstance(value, dict)
            else one(value) for name, value in tree.items()}


def _agent_from_jax(tree, dev):
    """A nested dict of arrays -> the same nesting of tensors on ``dev``,
    each with storage of its own (the reference's ``value_target`` is the
    value net's very arrays until the first update), dtypes kept."""
    if isinstance(tree, dict):
        return {k: _agent_from_jax(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def a2c_stack_from_jax(low_stack: dict, device=None) -> dict:
    """The reference's stacked A2C agents (``a2c.init_stacked``'s pytree
    as numpy arrays: actor, critic, and their Adam moments and step, each
    with a leading stream axis) -> the port's stack on the resolved
    device."""
    return _agent_from_jax(low_stack, resolve_device(device))


def sac_agent_from_jax(agent: dict, device=None) -> dict:
    """The reference's SAC agent (actor, value, value_target, q1, q2 and
    their Adam states, as numpy arrays) -> the port's on the resolved
    device."""
    return _agent_from_jax(agent, resolve_device(device))
