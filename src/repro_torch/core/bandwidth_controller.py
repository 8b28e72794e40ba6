"""Analytics-aware bandwidth controller, paper §IV-C and §V-B (port of
``repro.core.bandwidth_controller``).

Wraps the high-level SAC agent: observes S_high = (num, size, r, b_L, acc,
p), emits the per-stream bandwidth proportion vector every
``controller_interval`` chunks (10 s in the paper), and is trained with
reward r_high = min_c r_c (Eq. 6).  Baseline: even allocation.

Two act paths share one function: :meth:`proportions` calls
``act_proportions`` on each reallocation (the loop oracle), and
``repro_torch.core.bilevel.bilevel_step`` calls it inside its step and
hands the result back through :meth:`adopt`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.params import tree_leaves
from repro_torch.rl import sac
from repro_torch.rl.replay import ReplayBuffer

f32 = np.float32


def normalize_proportions(a):
    """Controller action -> bandwidth proportions (floor 1e-3, sum 1)."""
    p = a + 1e-3
    return p / p.sum(-1, keepdim=True)


def act_proportions(eps, agent, state, explore: bool = True):
    """(raw action, normalised proportions): the raw action feeds the
    replay buffer, the proportions the allocation and every low-level
    state."""
    a = sac.act(eps, agent, state, explore)
    return a, normalize_proportions(a)


def batch_to(batch: dict, device) -> dict:
    """A sampled numpy minibatch as f32 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, f32)).to(device)
            for k, v in batch.items()}


@dataclasses.dataclass
class BandwidthController:
    agent: dict
    cfg: sac.SACConfig
    buffer: ReplayBuffer
    interval: int = 10
    _last_state: np.ndarray | None = None
    _last_action: np.ndarray | None = None
    _current: np.ndarray | None = None
    updates: int = 0

    @classmethod
    def create(cls, generator: torch.Generator, state_dim: int,
               n_streams: int, interval: int = 10, *, device):
        cfg = sac.SACConfig(state_dim=state_dim, action_dim=n_streams)
        agent = sac.init(generator, cfg, device)
        buf = ReplayBuffer(cfg.buffer_size, state_dim, n_streams)
        return cls(agent=agent, cfg=cfg, buffer=buf, interval=interval)

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.agent)[0].device

    def needs_act(self, t: int) -> bool:
        return self._current is None or t % self.interval == 0

    def proportions(self, eps, state: np.ndarray, t: int,
                    explore: bool = True) -> np.ndarray:
        """Controller action; recomputed every ``interval`` chunks from
        the (C,) standard normal draws ``eps``."""
        if self.needs_act(t):
            a, p = act_proportions(
                eps, self.agent, torch.from_numpy(state).to(self.device),
                explore)
            self.adopt(a.cpu().numpy(), p.cpu().numpy().astype(f32), state)
        return self._current

    def adopt(self, raw_action: np.ndarray, props: np.ndarray,
              state: np.ndarray):
        """Install a freshly computed action (from :meth:`proportions` or
        from ``bilevel_step`` on the chunks that recompute)."""
        self._last_state = state
        self._last_action = raw_action
        self._current = props

    def record(self, reward: float, next_state: np.ndarray,
               done: bool = False):
        if self._last_state is not None:
            self.buffer.add(self._last_state, self._last_action, reward,
                            next_state, done)

    def ready(self) -> bool:
        return len(self.buffer) >= self.cfg.minibatch

    def train(self, eps, n_updates: int = 1) -> list:
        """Up to ``n_updates`` SAC updates, each from a fresh minibatch
        and the pair of (minibatch, C) draws ``eps``."""
        logs = []
        for _ in range(n_updates):
            if not self.ready():
                break
            batch = batch_to(self.buffer.sample(self.cfg.minibatch),
                             self.device)
            self.agent, log = sac.update(eps, self.agent, batch, self.cfg)
            self.updates += 1
            logs.append(log)
        return logs


def even_proportions(n_streams: int) -> np.ndarray:
    return np.full(n_streams, 1.0 / n_streams, f32)
