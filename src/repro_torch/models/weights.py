"""Carry TinyDetector weights across from the JAX reference."""
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
