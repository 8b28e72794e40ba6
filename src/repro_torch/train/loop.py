"""Generic training loop: data -> step -> checkpoints (port of
``repro.train.loop``).

Periodic and final checkpoints (optionally written on a thread), metric
logging, and resume from the latest checkpoint.  The metrics of a step
stay on the device except at a log point, where they reach the host in
one copy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.train import checkpoint as CKPT


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 10
    async_ckpt: bool = False
    keep: int = 3


def _host_metrics(metrics: dict) -> dict:
    """Metric values as Python floats: the tensors among them stacked in
    f64 (exact for f32 and int32 values) and copied to the host once."""
    out = {k: float(v) for k, v in metrics.items()
           if not isinstance(v, torch.Tensor)}
    tensors = {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)}
    if tensors:
        dev = next(iter(tensors.values())).device
        vals = torch.stack([v.detach().reshape(()).to(dev, torch.float64)
                            for v in tensors.values()]).tolist()
        out.update(zip(tensors, vals))
    return {k: out[k] for k in metrics}


def run(step_fn: Callable, state, data_iter: Iterator, cfg: LoopConfig,
        *, state_shardings=None, on_metrics=None, fail_injector=None):
    """Runs the loop; returns (final_state, history).

    ``fail_injector(step) -> bool`` simulates a node failure: the loop
    raises ``RuntimeError`` and the supervisor restarts from the latest
    checkpoint (``train/fault_tolerance.py``).
    """
    start = 0
    if cfg.ckpt_dir:
        last = CKPT.latest_step(cfg.ckpt_dir)
        if last is not None:
            state = CKPT.restore(cfg.ckpt_dir, last, state,
                                 shardings=state_shardings)
            start = last
    history = []
    t0 = time.time()
    for step in range(start, cfg.total_steps):
        if fail_injector is not None and fail_injector(step):
            raise RuntimeError(f"injected failure at step {step}")
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if (step + 1) % cfg.log_every == 0 or step + 1 == cfg.total_steps:
            m = _host_metrics(metrics)
            m["step"] = step + 1
            m["steps_per_s"] = (step + 1 - start) / max(time.time() - t0,
                                                        1e-9)
            history.append(m)
            if on_metrics:
                on_metrics(m)
        if cfg.ckpt_dir and ((step + 1) % cfg.ckpt_every == 0
                             or step + 1 == cfg.total_steps):
            CKPT.save(cfg.ckpt_dir, step + 1, state, keep=cfg.keep,
                      blocking=not cfg.async_ckpt)
    return state, history
