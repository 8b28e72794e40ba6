"""Fault tolerance: supervised restarts (port of
``repro.train.fault_tolerance``).

``supervise`` wraps ``train.loop.run``: on a failure (a lost node surfaces
as a ``RuntimeError`` in the runner) it rebuilds the step and state and
runs again, and the loop resumes from the latest checkpoint.  Checkpoints
are the source of truth; ``ckpt_every`` bounds the work lost.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.train import loop as LOOP


@dataclasses.dataclass
class SuperviseResult:
    state: object
    history: list
    restarts: int


def supervise(make_step_and_state: Callable, data_factory: Callable,
              cfg: LOOP.LoopConfig, *, max_restarts: int = 3,
              fail_injector=None, on_restart=None) -> SuperviseResult:
    """make_step_and_state(attempt) -> (step_fn, state, state_shardings).

    Called again on every attempt, so the caller can rebuild; the
    failure injector acts on the first attempt only.
    """
    restarts = 0
    history_all = []
    while True:
        step_fn, state, shardings = make_step_and_state(restarts)
        try:
            state, hist = LOOP.run(
                step_fn, state, data_factory(), cfg,
                state_shardings=shardings,
                fail_injector=fail_injector if restarts == 0 else None)
            history_all.extend(hist)
            return SuperviseResult(state=state, history=history_all,
                                   restarts=restarts)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(restarts)
