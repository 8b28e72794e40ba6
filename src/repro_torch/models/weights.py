"""Carry weights across from the JAX reference: the TinyDetector's and
the decoder LM's."""
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
