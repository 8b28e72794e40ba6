"""Fairness objectives for the bandwidth controller, paper Eq. 1 and Eq. 6
(port of ``repro.core.fairness``)."""
from __future__ import annotations

import torch

f32 = torch.float32


def min_reward_fairness(rewards):
    """max-min fairness: the controller maximises the worst stream (Eq. 6)."""
    return torch.as_tensor(rewards, dtype=f32).min()


def jain_index(values):
    """Jain's fairness index in [1/n, 1]."""
    v = torch.as_tensor(values, dtype=f32)
    return v.sum().square() / (v.shape[0] * (v * v).sum()).clamp(min=1e-9)


def accuracy_spread(accs, lo: float = 0.5, hi: float = 0.75):
    """Percentile spread of per-stream accuracy (paper Fig. 12)."""
    v = torch.sort(torch.as_tensor(accs, dtype=f32)).values
    n = v.shape[0]
    return v[int(hi * (n - 1))] - v[int(lo * (n - 1))]


def fairness_head(rewards, accs) -> dict:
    """The cross-stream reductions of the bi-level step in one place, so
    that the step and the host-side logs agree on them: the controller
    reward r_high = min_c r_c (Eq. 6), Jain's index and the percentile
    spread of the per-stream accuracy."""
    return {"r_high": min_reward_fairness(rewards),
            "jain": jain_index(accs),
            "spread": accuracy_spread(accs)}
