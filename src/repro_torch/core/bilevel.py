"""Bi-level joint training, paper §V and Fig. 9 (port of
``repro.core.bilevel``).

The high level (bandwidth controller, SAC) and the low level (per-camera
frame classification agents, A2C) train jointly: the controller's action
conditions every agent's state (the allocations are part of S_c), and the
agents' decisions feed back into S_high (anchor proportions, accuracy).
Experience flows every chunk; the controller acts every
``controller_interval`` chunks.

The C low-level agents live in one stack (``a2c.init_stacked``), and
:func:`bilevel_step` runs a chunk's whole control sequence as one plain
PyTorch function: the stacked A2C update, the SAC update, the controller
proportions, the low-level states, all C threshold actions and the Eq. 6
fairness reductions.  The environment sits between act and train, so the
step is shifted by one chunk: the step of chunk t first applies the
updates for chunk t-1's transitions, then acts for chunk t, and
:meth:`BiLevelTrainer.flush` applies the last one.  The order of update
and act is the loop's, so :meth:`BiLevelTrainer.run_chunk` agrees with the
per-stream loop :meth:`BiLevelTrainer.run_chunk_loop`: actions, rewards,
metrics and, after ``flush``, parameters.

Noise: each chunk's standard normal draws come from the trainer's
``noise`` object, one ``chunk(C, minibatch)`` call a chunk, in a fixed
order (see :class:`ChunkNoise`); both paths draw the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bandwidth_controller import (BandwidthController,
                                                   act_proportions, batch_to)
from repro_torch.core.fairness import fairness_head, jain_index
from repro_torch.device import resolve_device
from repro_torch.rl import a2c, sac
from repro_torch.rl.replay import StackedReplayBuffer
from repro_torch.sim.env import (EnvConfig, MultiStreamEnv, high_state_dim,
                                 low_alloc_offset, low_state_dim)

f32 = np.float32

# threshold actions in (0,1) scale into the feature range (~[0, 0.5])
THRESHOLD_SCALE = (0.5, 0.5)


class ChunkNoise:
    """A chunk's standard normal draws, from a CPU ``torch.Generator`` in
    one draw, split in this order: the SAC act's (C,), the C A2C acts'
    (C, 2), and the SAC update's two (minibatch, C); moved to ``device``
    in one copy."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator().manual_seed(seed)
        self.device = torch.device(device)

    def chunk(self, n_streams: int, minibatch: int):
        C, M = n_streams, minibatch
        z = torch.randn(3 * C + 2 * M * C,
                        generator=self.generator).to(self.device)
        hi, lo, tr1, tr2 = z.split([C, 2 * C, M * C, M * C])
        return hi, lo.reshape(C, 2), (tr1.reshape(M, C), tr2.reshape(M, C))


def bilevel_step(low_stack, sac_agent, eps_hi, eps_lo, eps_tr, s_high,
                 cached_raw, cached_props, recompute: bool, s_low_base,
                 prev_rewards, prev_accs, low_batch, sac_batch, *,
                 low_cfg: a2c.A2CConfig, sac_cfg: sac.SACConfig,
                 explore: bool, do_low: bool, do_high: bool,
                 alloc_off: int) -> dict:
    """The bi-level control plane of a chunk, on the agents' device.

    Trains on the previous chunk's transitions first (stacked A2C update,
    SAC update, each when its flag is set), then acts: the controller's
    proportions (fresh when ``recompute``, else the cached ones), the
    low-level states (the host-built base with the proportions written
    at ``alloc_off``) and all C thresholds.  Returns the new agents, the
    actions and the logs as tensors.
    """
    logs = {"fair": fairness_head(prev_rewards, prev_accs)}
    if do_low:
        low_stack, logs["low"] = a2c.update_stacked(low_stack, low_batch,
                                                    low_cfg)
    if do_high:
        sac_agent, logs["high"] = sac.update(eps_tr, sac_agent, sac_batch,
                                             sac_cfg)
    if recompute:
        raw, props = act_proportions(eps_hi, sac_agent, s_high, explore)
    else:
        raw, props = cached_raw, cached_props
    C = props.shape[0]
    s_low = s_low_base.clone()
    s_low[:, alloc_off:alloc_off + C] = props
    actions = a2c.act_stacked(eps_lo, low_stack, s_low, explore)
    thr = actions * torch.tensor(THRESHOLD_SCALE, device=actions.device)
    return {"low_stack": low_stack, "sac_agent": sac_agent, "raw": raw,
            "props": props, "s_low": s_low, "actions": actions,
            "thr": thr, "logs": logs}


def _seeds(seed: int) -> tuple[int, int]:
    """Independent seeds of the initialisation and the noise generator."""
    children = np.random.SeedSequence(seed).spawn(2)
    return tuple(int(s.generate_state(1)[0]) for s in children)


@dataclasses.dataclass
class BiLevelTrainer:
    env: MultiStreamEnv
    low_stack: dict
    low_cfg: a2c.A2CConfig
    controller: BandwidthController
    low_buffer: StackedReplayBuffer
    noise: ChunkNoise
    low_batch: int = 32
    # the update for chunk t's transitions rides in chunk t+1's step
    _pending: dict | None = None

    @classmethod
    def create(cls, cfg: EnvConfig, seed: int = 0, detector=None,
               low_batch: int = 32, device=None):
        """The env, C agents and the controller from ``seed``, on CUDA
        unless ``device`` says otherwise."""
        dev = resolve_device(device)
        env = MultiStreamEnv(cfg, detector=detector, device=dev)
        init_seed, noise_seed = _seeds(seed)
        g = torch.Generator().manual_seed(init_seed)
        C = len(cfg.streams)
        sdim = low_state_dim(cfg)
        low_cfg = a2c.A2CConfig(state_dim=sdim, tau_latency=cfg.latency_tau)
        low_stack = a2c.init_stacked(g, C, low_cfg, dev)
        controller = BandwidthController.create(
            g, high_state_dim(cfg), C, cfg.controller_interval, device=dev)
        buf = StackedReplayBuffer(4096, C, sdim, 2)
        return cls(env=env, low_stack=low_stack, low_cfg=low_cfg,
                   controller=controller, low_buffer=buf,
                   noise=ChunkNoise(noise_seed, dev), low_batch=low_batch)

    # ------------------------------------------------------------------
    def _chunk_noise(self):
        return self.noise.chunk(self.env.C, self.controller.cfg.minibatch)

    def _post_step(self, results, s_low, thresholds, props, eps_tr, train):
        """Everything after the env step, the same in both paths: rewards,
        controller experience, low-level replay writes, and the deferred
        update's book-keeping."""
        env, C = self.env, self.env.C
        rewards = np.asarray([r["reward"] for r in results], f32)
        r_high = float(rewards.min())                     # Eq. 6
        s_high2 = env.observe_high()
        self.controller.record(r_high, s_high2)
        s_low2 = env.observe_low_batched(props)
        self.low_buffer.add_batch(s_low, thresholds, rewards, s_low2,
                                  np.zeros(C, f32))
        self._pending = {
            "eps_tr": eps_tr,
            "do_low": bool(train and len(self.low_buffer) >= self.low_batch),
            "do_high": bool(train and self.controller.ready()),
            "rewards": rewards,
            "accs": np.asarray([r["accuracy"] for r in results], f32),
        }
        return rewards, r_high

    def _metrics(self, results, r_high):
        accs = [r["accuracy"] for r in results]
        return {
            "mean_acc": float(np.mean(accs)),
            "min_acc": float(np.min(accs)),
            "mean_latency": float(np.mean([r["latency"] for r in results])),
            "reward_min": r_high,
            "jain": float(jain_index(np.asarray(accs, f32))),
            "utilization": float(np.mean([r["utilization"]
                                          for r in results])),
            "anchor_frac": float(np.mean([r["n_anchor"] / len(r["types"])
                                          for r in results])),
        }

    def _to_device(self, x):
        return torch.from_numpy(np.ascontiguousarray(x, f32)).to(
            self.env.device)

    # ------------------------------------------------------------------
    def run_chunk(self, explore: bool = True, train: bool = True):
        """One ``bilevel_step`` a chunk (the deferred update of the
        previous chunk and all of this chunk's actions), then the env
        step.  Call :meth:`flush` after the last chunk to apply the last
        deferred update."""
        env, C = self.env, self.env.C
        eps_hi, eps_lo, eps_tr = self._chunk_noise()

        s_high = env.observe_high()
        s_low_base = env.observe_low_batched(None)
        recompute = self.controller.needs_act(env.t)
        pend = self._pending
        do_low = bool(pend and pend["do_low"])
        do_high = bool(pend and pend["do_high"])
        low_b = batch_to(self.low_buffer.sample(self.low_batch),
                         env.device) if do_low else None
        sac_b = batch_to(self.controller.buffer.sample(
            self.controller.cfg.minibatch), env.device) if do_high else None
        zc = np.zeros(C, f32)
        cached_raw = self.controller._last_action \
            if self.controller._last_action is not None else zc
        cached_props = self.controller._current \
            if self.controller._current is not None else zc
        off = low_alloc_offset(env.cfg)
        out = bilevel_step(
            self.low_stack, self.controller.agent, eps_hi, eps_lo,
            pend["eps_tr"] if pend else eps_tr, self._to_device(s_high),
            self._to_device(cached_raw), self._to_device(cached_props),
            recompute, self._to_device(s_low_base),
            self._to_device(pend["rewards"] if pend else zc),
            self._to_device(pend["accs"] if pend else zc),
            low_b, sac_b, low_cfg=self.low_cfg, sac_cfg=self.controller.cfg,
            explore=explore, do_low=do_low, do_high=do_high, alloc_off=off)

        self.low_stack = out["low_stack"]
        if do_high:
            self.controller.agent = out["sac_agent"]
            self.controller.updates += 1
        # every value the host reads, in one copy: proportions, the raw
        # action, the thresholds and the logs
        logs_out = out["logs"]
        parts = [out["props"], out["raw"], out["actions"].reshape(-1),
                 torch.stack(list(logs_out["fair"].values()))]
        if do_low:
            parts.append(torch.stack(list(logs_out["low"].values()), 1)
                         .reshape(-1))
        if do_high:
            parts.append(torch.stack(list(logs_out["high"].values())))
        host = torch.cat([p.reshape(-1).to(torch.float32) for p in parts]) \
            .cpu().numpy()
        props, raw = host[:C].copy(), host[C:2 * C].copy()
        thresholds = host[2 * C:4 * C].reshape(C, 2).copy()
        rest = host[4 * C:]
        if recompute:
            self.controller.adopt(raw, props, s_high)
        thr = thresholds * np.asarray(THRESHOLD_SCALE, f32)
        s_low = s_low_base.copy()
        s_low[:, off:off + C] = props

        results, info = env.step(props, thr)
        _, r_high = self._post_step(results, s_low, thresholds, props,
                                    eps_tr, train)
        logs = {}
        if pend:
            # the fairness reductions of the previous chunk's outcome
            logs["fair_prev"] = dict(zip(logs_out["fair"],
                                         map(float, rest[:3])))
        rest = rest[3:]
        if do_low:
            names = list(logs_out["low"])
            rows = rest[:C * len(names)].reshape(C, len(names))
            for c in range(C):
                logs[f"low{c}"] = dict(zip(names, map(float, rows[c])))
            rest = rest[C * len(names):]
        if do_high:
            logs["high"] = dict(zip(logs_out["high"], map(float, rest)))
        return self._metrics(results, r_high), results, info, logs

    def flush(self):
        """Apply the deferred final update (a no-op when nothing is
        pending).  After ``run_chunk`` x n + ``flush()`` the parameters
        equal ``run_chunk_loop`` x n's."""
        pend, self._pending = self._pending, None
        logs = {}
        if pend and pend["do_low"]:
            batch = batch_to(self.low_buffer.sample(self.low_batch),
                             self.env.device)
            self.low_stack, llog = a2c.update_stacked(
                self.low_stack, batch, self.low_cfg)
            for c in range(self.env.C):
                logs[f"low{c}"] = {k: float(v[c]) for k, v in llog.items()}
        if pend and pend["do_high"]:
            hlogs = self.controller.train(pend["eps_tr"], n_updates=1)
            if hlogs:
                logs["high"] = {k: float(v) for k, v in hlogs[-1].items()}
        return logs

    # ------------------------------------------------------------------
    def run_chunk_loop(self, explore: bool = True, train: bool = True):
        """The per-stream loop: the controller, then each agent's act
        and update on its own, the reference sequence of paper Fig. 9 and
        the oracle that ``run_chunk`` is held against."""
        self.flush()    # mode mixing: apply any deferred update first
        env, C = self.env, self.env.C
        eps_hi, eps_lo, eps_tr = self._chunk_noise()

        s_high = env.observe_high()
        props = self.controller.proportions(eps_hi, s_high, env.t, explore)
        s_low = np.stack([env.observe_low(c, props) for c in range(C)])
        thresholds = np.stack([
            a2c.act(eps_lo[c], a2c.slice_agent(self.low_stack, c),
                    self._to_device(s_low[c]), explore).cpu().numpy()
            for c in range(C)])
        thr = thresholds * np.asarray(THRESHOLD_SCALE, f32)

        results, info = env.step(props, thr)
        rewards, r_high = self._post_step(results, s_low, thresholds,
                                          props, eps_tr, train)
        self._pending = None        # the loop trains inside the chunk

        logs = {}
        if train:
            lens = self.low_buffer.lens()
            for c in range(C):
                if lens[c] >= self.low_batch:
                    batch = batch_to(self.low_buffer.sample_stream(
                        c, self.low_batch), env.device)
                    agent_c, llog = a2c.update(
                        a2c.slice_agent(self.low_stack, c), batch,
                        self.low_cfg)
                    self.low_stack = a2c.set_agent(self.low_stack, c,
                                                   agent_c)
                    logs[f"low{c}"] = {k: float(v) for k, v in llog.items()}
            hlogs = self.controller.train(eps_tr, n_updates=1)
            if hlogs:
                logs["high"] = {k: float(v) for k, v in hlogs[-1].items()}
        return self._metrics(results, r_high), results, info, logs

    def train_steps(self, n: int, explore: bool = True):
        history = []
        for _ in range(n):
            metrics, _, _, _ = self.run_chunk(explore=explore, train=True)
            history.append(metrics)
        self.flush()
        return history
