"""Straggler mitigation for the serving plane (port of
``repro.serving.straggler``: the same numpy and thread code).

At pod scale, slow replicas dominate tail latency.  Two mechanisms:

  * ``HedgedExecutor`` — speculative re-issue: if a shard's result hasn't
    arrived within quantile-based deadline t_q, the request is re-issued to
    a backup replica; first result wins.  (Serving plane.)
  * ``StragglerDetector`` — per-step timing stats; replicas slower than
    median × threshold for ``patience`` consecutive steps are flagged for
    eviction, which triggers the elastic re-mesh path
    (``repro_torch.serving.runtime.EdgeRuntime.poll_faults``).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable

import numpy as np


@dataclasses.dataclass
class HedgeConfig:
    quantile: float = 0.95
    min_history: int = 20
    max_hedges: int = 1


class HedgedExecutor:
    """First-result-wins speculative execution over interchangeable
    replicas.

    Two paths share the deadline/accounting logic:

      * simulated (``simulate_latency`` given) — replica latency is the
        callable's answer; fully deterministic, used by tests and the
        chaos soak.
      * wall clock — the primary runs on a worker thread; if it misses
        the quantile deadline, the backup is issued on the caller's
        thread and whichever finishes first (by timestamp) wins.  The
        primary is never cancelled (a queued launch cannot be withdrawn);
        a hedge costs duplicated work, not correctness.  A replica's time
        is the time of its call, which on CUDA is its dispatch: nothing
        here waits for the device.
    """

    def __init__(self, cfg: HedgeConfig, replicas: list[Callable]):
        self.cfg = cfg
        self.replicas = replicas
        self.lat: deque = deque(maxlen=500)
        self.hedges = 0
        self.rr = 0
        self._pool = None    # lazy: most runs never hedge on wall clock

    def _deadline(self) -> float:
        if len(self.lat) < self.cfg.min_history:
            return float("inf")
        return float(np.quantile(np.asarray(self.lat), self.cfg.quantile))

    def _run_wall(self, payload, primary: int, deadline: float):
        can_hedge = (len(self.replicas) > 1 and self.cfg.max_hedges >= 1
                     and np.isfinite(deadline))
        t0 = time.perf_counter()
        if not can_hedge:
            out = self.replicas[primary](payload)
            self.lat.append(time.perf_counter() - t0)
            return out, primary
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="hedge")

        def timed(idx):
            r = self.replicas[idx](payload)
            return r, time.perf_counter()

        fut = self._pool.submit(timed, primary)
        try:
            out, _ = fut.result(timeout=deadline)
            self.lat.append(time.perf_counter() - t0)
            return out, primary
        except concurrent.futures.TimeoutError:
            pass
        # primary missed its deadline: issue the backup here, then take
        # whichever actually finished first
        self.hedges += 1
        backup = (primary + 1) % len(self.replicas)
        out_b, t_b = timed(backup)
        if fut.done() and not fut.exception():
            out_p, t_p = fut.result()
            if t_p <= t_b:
                self.lat.append(t_p - t0)
                return out_p, primary
        self.lat.append(t_b - t0)
        return out_b, backup

    def run(self, payload, *, simulate_latency: Callable | None = None,
            primary: int | None = None):
        """Returns ``(result, winning_replica)``.

        ``simulate_latency(replica_idx)`` supplies deterministic latencies
        (tests / chaos soak); wall clock otherwise.  ``primary`` pins the
        first-choice replica (stream-affinity routing); round-robin when
        omitted.
        """
        if primary is None:
            primary = self.rr % len(self.replicas)
            self.rr += 1
        deadline = self._deadline()
        if simulate_latency is not None:
            lat = simulate_latency(primary)
            if lat > deadline and len(self.replicas) > 1 \
                    and self.cfg.max_hedges >= 1:
                self.hedges += 1
                backup = (primary + 1) % len(self.replicas)
                lat2 = simulate_latency(backup)
                winner = backup if lat2 < lat else primary
                self.lat.append(min(lat, lat2))
                return self.replicas[winner](payload), winner
            self.lat.append(lat)
            return self.replicas[primary](payload), primary
        return self._run_wall(payload, primary, deadline)

    def close(self):
        """Shut the lazy hedge thread pool down.  Idempotent — safe to
        call on an executor that never hedged on wall clock.  Without
        this, the 2 worker threads outlive the executor (they leaked
        across EdgeRuntime lifecycles and test runs before the runtime
        teardown path called it)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@dataclasses.dataclass
class DetectorConfig:
    threshold: float = 1.5          # × median
    patience: int = 5
    # sliding per-replica timing window the medians come from: small
    # windows react to a fresh slowdown within a few steps, large ones
    # smooth over transients
    window: int = 100


class StragglerDetector:
    def __init__(self, cfg: DetectorConfig, n_replicas: int):
        self.cfg = cfg
        self.n = n_replicas
        self.strikes = np.zeros(n_replicas, np.int64)
        self.history = defaultdict(lambda: deque(maxlen=cfg.window))

    def record(self, replica: int, step_time: float):
        self.history[replica].append(step_time)

    def reset(self, replica: int):
        """Forget a replica's record — used when a recovered device
        rejoins the pool so stale slow samples can't re-flag it."""
        self.strikes[replica] = 0
        self.history[replica].clear()

    def flagged(self) -> list[int]:
        medians = [np.median(self.history[i]) if self.history[i] else 0.0
                   for i in range(self.n)]
        global_med = np.median([m for m in medians if m > 0] or [0.0])
        out = []
        for i in range(self.n):
            if medians[i] > self.cfg.threshold * max(global_med, 1e-12):
                self.strikes[i] += 1
            else:
                self.strikes[i] = 0
            if self.strikes[i] >= self.cfg.patience:
                out.append(i)
        return out
