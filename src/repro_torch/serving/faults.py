"""Chaos harness for the serving plane: seeded, deterministic fault
schedules and the closed-loop soak (port of
``repro.serving.faults``; the schedules are the same numpy code).

BiSwift's premise is sustained accuracy under a hostile environment (FCC
bandwidth collapses, 9+ competing streams, a small edge GPU), so the
runtime must be exercised against failure, not just sunshine.  This
module is the single source of injected misbehaviour:

  * :class:`FaultSchedule` — a list of :class:`FaultEvent` windows plus a
    seed.  Every query (``chunk_lost``, ``shard_slowdown``, ...) is a pure
    function of (seed, event list, query args): two schedules built the
    same way answer identically, so chaos soaks are replayable and CI can
    assert exact recovery behaviour.
  * preset schedules (:func:`preset_schedule`) — the named fault mixes the
    acceptance tests and ``benchmarks/chaos.py`` run.
  * :func:`run_soak` — the closed loop: N chunks of C streams
    through an :class:`~repro_torch.serving.runtime.EdgeRuntime` under a
    schedule, producing per-chunk fps series, per-stream degradation
    stats, and the accounting/recovery report the chaos tests assert on.

Fault kinds
-----------
``bw_collapse``
    total uplink bandwidth × ``magnitude`` over ``[t0, t1)``.
``outage``
    correlated outage burst: bandwidth × ``magnitude`` (≈0) over the
    window — composes multiplicatively with collapses.
``stall``
    camera stall: stream ``target`` produces no chunks in the window
    (bandwidth allocated to it is wasted; no frames enter accounting).
``leave`` / ``join``
    stream churn.  ``leave`` removes stream ``target`` over ``[t0, t1)``
    (it rejoins at ``t1``); ``join`` keeps the stream offline UNTIL
    ``t0`` (a late-joining camera).
``chunk_loss``
    the chunk a stream offloads is lost in transit with probability
    ``magnitude`` per chunk (``target == -1``: every stream).
    Retransmissions face the same per-try loss probability.
``chunk_corrupt``
    the chunk arrives but fails its checksum with probability
    ``magnitude`` — the payload is untrusted, so after detection it is
    handled exactly like a loss (retry ladder), counted separately.
``shard_slow``
    device shard ``target`` runs ``magnitude``× slower (straggler);
    ``magnitude`` ≫ 1 models a hung device.  Feeds the runtime's
    simulated step timings, so ``StragglerDetector`` eviction fires
    deterministically.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.codec.rate_model import (ladder_for_bandwidth,
                                          video_bandwidth_share)
from repro_torch.core.forecast import StreamForecaster
from repro_torch.core.hybrid_encoder import encode_hybrid
from repro_torch.device import resolve_device
from repro_torch.models import detection as D
from repro_torch.serving.runtime import DegradeConfig, EdgeRuntime
from repro_torch.serving.scheduler import ServingConfig
from repro_torch.serving.straggler import DetectorConfig
from repro_torch.sim.network import (TraceConfig, apply_fault_profile,
                                     generate_trace)
from repro_torch.sim.video_source import StreamConfig, generate_chunk

FAULT_KINDS = ("bw_collapse", "outage", "stall", "leave", "join",
               "chunk_loss", "chunk_corrupt", "shard_slow")

# kinds that dent throughput — the recovery analysis measures steady-state
# fps against the union of these windows
DISRUPTIVE_KINDS = frozenset(FAULT_KINDS) - {"join"}

_KIND_CODE = {k: i for i, k in enumerate(FAULT_KINDS)}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault window ``[t0, t1)`` (chunk indices)."""
    kind: str
    t0: int
    t1: int
    target: int = -1          # stream / shard id; -1 = every target
    magnitude: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if self.t1 < self.t0:
            raise ValueError(f"fault window ends before it starts: "
                             f"[{self.t0}, {self.t1})")
        if self.magnitude < 0.0:
            raise ValueError(f"fault magnitude must be >= 0, "
                             f"got {self.magnitude}")

    def active(self, t: int) -> bool:
        return self.t0 <= t < self.t1


class FaultSchedule:
    """Deterministic fault oracle over a list of :class:`FaultEvent`.

    Randomized outcomes (a chunk-loss coin, a retry outcome) are drawn
    from a generator seeded by ``(seed, kind, target, t, ...)`` — never
    from shared mutable RNG state — so query order cannot change any
    answer and replays are exact.
    """

    def __init__(self, events, *, seed: int = 0):
        self.events = tuple(events)
        self.seed = int(seed)

    # -------------------------------------------------------------- coins
    def _coin(self, *ids: int) -> float:
        # mask to uint32 words: SeedSequence rejects negative entropy
        words = [self.seed & 0xFFFFFFFF] + [int(i) & 0xFFFFFFFF
                                            for i in ids]
        return float(np.random.default_rng(words).random())

    def _active(self, kind: str, t: int):
        return [e for e in self.events if e.kind == kind and e.active(t)]

    # ---------------------------------------------------------- bandwidth
    def bw_multiplier(self, t: int) -> float:
        """Product of active collapse/outage magnitudes (1.0 = clean)."""
        m = 1.0
        for e in self._active("bw_collapse", t) + self._active("outage", t):
            m *= e.magnitude
        return m

    def bw_multipliers(self, n_steps: int) -> np.ndarray:
        """(n_steps,) profile for
        :func:`repro_torch.sim.network.apply_fault_profile`."""
        return np.asarray([self.bw_multiplier(t) for t in range(n_steps)])

    # --------------------------------------------------------------- churn
    def stalled(self, stream: int, t: int) -> bool:
        return any(e.target in (-1, stream)
                   for e in self._active("stall", t))

    def stream_active(self, stream: int, t: int) -> bool:
        """False while a ``leave`` window covers t, or before a ``join``
        event's start for that stream."""
        for e in self.events:
            if e.kind == "leave" and e.target in (-1, stream) \
                    and e.active(t):
                return False
            if e.kind == "join" and e.target == stream and t < e.t0:
                return False
        return True

    def active_mask(self, t: int, n_streams: int) -> np.ndarray:
        return np.asarray([self.stream_active(c, t)
                           for c in range(n_streams)], bool)

    # ------------------------------------------------------ loss/corruption
    def _event_prob(self, kind: str, stream: int, t: int) -> float:
        probs = [e.magnitude for e in self._active(kind, t)
                 if e.target in (-1, stream)]
        return min(max(probs, default=0.0), 1.0)

    def chunk_lost(self, stream: int, t: int) -> bool:
        p = self._event_prob("chunk_loss", stream, t)
        return p > 0.0 and self._coin(_KIND_CODE["chunk_loss"],
                                      stream, t) < p

    def chunk_corrupt(self, stream: int, t: int) -> bool:
        p = self._event_prob("chunk_corrupt", stream, t)
        return p > 0.0 and self._coin(_KIND_CODE["chunk_corrupt"],
                                      stream, t) < p

    def retry_succeeds(self, stream: int, t: int, attempt: int) -> bool:
        """A retransmission of a lost/corrupt chunk traverses the same
        degraded link: per-try success probability is 1 − loss prob."""
        p = max(self._event_prob("chunk_loss", stream, t),
                self._event_prob("chunk_corrupt", stream, t))
        return self._coin(_KIND_CODE["chunk_loss"], stream, t,
                          1000 + attempt) >= p

    # -------------------------------------------------------------- shards
    def shard_slowdown(self, shard: int, t: int) -> float:
        """≥ 1.0 step-time multiplier for a device shard (1.0 = healthy)."""
        mags = [e.magnitude for e in self._active("shard_slow", t)
                if e.target in (-1, shard)]
        return max(max(mags, default=1.0), 1.0)

    # ------------------------------------------------------------ analysis
    def horizon(self) -> int:
        return max((e.t1 for e in self.events), default=0)

    def disruption_mask(self, n_steps: int) -> np.ndarray:
        """(n_steps,) bool — True where ANY throughput-denting fault is
        active.  Contiguous True runs are the 'fault regions' whose
        clearing the recovery analysis measures from."""
        m = np.zeros(n_steps, bool)
        for e in self.events:
            if e.kind in DISRUPTIVE_KINDS:
                m[max(e.t0, 0):max(min(e.t1, n_steps), 0)] = True
        return m


# ---------------------------------------------------------------------------
# preset schedules — the named fault mixes CI asserts on
# ---------------------------------------------------------------------------
PRESETS = ("bw-collapse", "loss-burst", "stream-churn", "shard-chaos")


def preset_schedule(name: str, *, n_chunks: int, n_streams: int = 3,
                    n_shards: int = 1, seed: int = 0) -> FaultSchedule:
    """Named deterministic schedules sized to an ``n_chunks`` soak.

    Each preset front-loads a clean warmup (steady-state baseline), puts
    its faults in the middle, and leaves a clean tail longer than the
    degradation ladder's recovery patience, so the ≥90 %-recovery
    assertion has room to hold.
    """
    P = int(n_chunks)
    if P < 12:
        raise ValueError(f"presets need n_chunks >= 12, got {P}")
    q = P // 4
    if name == "bw-collapse":
        events = [
            # magnitudes are deep because the soak's chunks are tiny
            # (a few kbit): 0.01x of an 8 Mbps uplink is what makes
            # transmission latency actually threaten the deadline
            FaultEvent("bw_collapse", q, q + max(P // 8, 1),
                       magnitude=0.01),
            FaultEvent("outage", 2 * q, 2 * q + max(P // 10, 2),
                       magnitude=0.001),
        ]
    elif name == "loss-burst":
        events = [
            # loss before any carry exists -> rung 4 (frame-skip)
            FaultEvent("chunk_loss", 0, 1, target=0, magnitude=1.0),
            # hard loss burst: every retry fails -> reuse-fallback rung
            FaultEvent("chunk_loss", q, q + 2, target=-1, magnitude=1.0),
            # flaky window on stream 0: retries usually recover the chunk
            FaultEvent("chunk_loss", 2 * q, 2 * q + max(P // 8, 2),
                       target=0, magnitude=0.5),
            FaultEvent("chunk_corrupt", 2 * q, 2 * q + max(P // 8, 2),
                       target=min(1, n_streams - 1), magnitude=0.7),
        ]
    elif name == "stream-churn":
        last = n_streams - 1
        events = [
            FaultEvent("join", 2, P, target=last),
            FaultEvent("leave", q, 2 * q, target=min(1, last)),
            FaultEvent("stall", 2 * q + 1, 2 * q + 3, target=0),
        ]
    elif name == "shard-chaos":
        events = [
            FaultEvent("shard_slow", q, 2 * q, target=n_shards - 1,
                       magnitude=8.0),
            FaultEvent("bw_collapse", 2 * q + 2, 2 * q + 2 + max(P // 10, 1),
                       magnitude=0.3),
        ]
    else:
        raise KeyError(f"unknown preset {name!r}; have {PRESETS}")
    return FaultSchedule(events, seed=seed)


def churn_schedule(n_chunks: int, n_streams: int, *, seed: int = 0,
                   join_frac: float = 0.25, leave_frac: float = 0.2,
                   stall_frac: float = 0.05,
                   loss_window: bool = True) -> FaultSchedule:
    """Many-stream churn generator for O(100)-stream soaks.

    Deterministic in ``seed``: the last ``join_frac`` of the streams join
    staggered over the first half of the horizon (late-arriving cameras),
    ``leave_frac`` of the early streams each take one leave window,
    ``stall_frac`` stall for a chunk mid-run, and (optionally) a global
    flaky-loss window exercises the retry ladder while the pool is at its
    churn peak.  Unlike the 3-stream presets, windows are drawn per
    stream, so at 64+ streams every chunk sees a different live set.
    """
    if n_chunks < 4:
        raise ValueError(f"churn needs n_chunks >= 4, got {n_chunks}")
    rng = np.random.default_rng(seed)
    events = []
    n_join = int(n_streams * join_frac)
    for c in range(n_streams - n_join, n_streams):
        t0 = int(rng.integers(1, max(n_chunks // 2, 2)))
        events.append(FaultEvent("join", t0, n_chunks, target=c))
    early = max(n_streams - n_join, 1)
    n_leave = min(int(n_streams * leave_frac), early)
    for c in rng.choice(early, size=n_leave, replace=False):
        a = int(rng.integers(1, max(n_chunks - 2, 2)))
        b = min(a + 1 + int(rng.integers(1, max(n_chunks // 3, 2))),
                n_chunks - 1)
        events.append(FaultEvent("leave", a, b, target=int(c)))
    for c in rng.choice(early, size=min(max(int(n_streams * stall_frac),
                                            1), early), replace=False):
        a = int(rng.integers(1, n_chunks - 1))
        events.append(FaultEvent("stall", a, a + 1, target=int(c)))
    if loss_window:
        mid = n_chunks // 2
        events.append(FaultEvent("chunk_loss", mid, mid + 2, target=-1,
                                 magnitude=0.3))
    return FaultSchedule(events, seed=seed)


# ---------------------------------------------------------------------------
# closed-loop chaos soak
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SoakConfig:
    n_streams: int = 3
    n_chunks: int = 24
    chunk_frames: int = 4
    height: int = 32
    width: int = 48
    fps: float = 30.0
    n_shards: int = 1
    gpu_capacity_fps: float = 480.0
    latency_budget: float = 1.0
    mean_kbps: float = 8000.0
    recovery_chunks: int = 6          # K: post-fault chunks to recover in
    recovery_frac: float = 0.9        # ...to >= this fraction of baseline
    tr1: float = 0.05
    tr2: float = 0.1
    seed: int = 0
    # shared-content pools for many-stream soaks: stream c renders the
    # frames of group ``c % content_groups`` (None = per-stream content,
    # the historical behavior).  64 streams over 8 pools keep the encode
    # cache small while every stream still runs its own control ladder.
    content_groups: int | None = None


def _recovery_report(fps_norm: np.ndarray, disrupted: np.ndarray,
                     cfg: SoakConfig) -> list[dict]:
    """Per fault-region recovery verdicts.

    For each maximal contiguous disrupted run ``[a, b)``: baseline = mean
    normalized fps over the clean chunks immediately preceding ``a``
    (after the previous region's own K-chunk recovery allowance); the
    region recovers if some chunk in ``[b, b+K]`` reaches
    ``recovery_frac × baseline``.  Regions without a clean pre-window or
    without post-fault room are reported unchecked (``baseline=None``).
    """
    n = fps_norm.size
    K = cfg.recovery_chunks
    regions = []
    a = None
    for t in range(n):
        if disrupted[t] and a is None:
            a = t
        elif not disrupted[t] and a is not None:
            regions.append((a, t))
            a = None
    if a is not None:
        regions.append((a, n))
    out = []
    prev_end = 0
    for a, b in regions:
        # clean window preceding the region, skipping the previous
        # region's own K-chunk recovery allowance when there is room
        pre_lo = min(prev_end + K, a)
        if pre_lo >= a:
            pre_lo = prev_end
        pre = fps_norm[pre_lo:a]
        entry = {"t0": int(a), "t1": int(b), "baseline": None,
                 "recovered_at": None, "recovered_in": None, "ok": None}
        if pre.size and b + 1 <= n:
            base = float(pre.mean())
            entry["baseline"] = base
            hi = min(b + K + 1, n)
            hit = [t for t in range(b, hi)
                   if fps_norm[t] >= cfg.recovery_frac * base]
            if hit:
                entry["recovered_at"] = int(hit[0])
                entry["recovered_in"] = int(hit[0] - b)
                entry["ok"] = True
            else:
                entry["ok"] = False
        prev_end = b
        out.append(entry)
    return out


def run_soak(cfg: SoakConfig, schedule: FaultSchedule, *,
             degrade=None, detector=None, batch_submit: bool = False,
             forecast=None, device=None) -> dict:
    """Drive an :class:`EdgeRuntime` through ``n_chunks`` of churning,
    faulty streams and report accounting + recovery.

    Per chunk: the schedule decides which streams are live/stalled, the
    (faulted) trace splits evenly across live streams, each live stream
    encodes at the runtime's suggested (possibly demoted) ladder rung and
    offers its chunk to ``process_chunk``; modeled chunk latency feeds the
    deadline ladder, and ``poll_faults`` runs straggler eviction/recovery
    once per chunk.  Content per stream is a fixed seeded chunk re-offered
    every step (encodes are cached per (content group, rung)) — the soak
    exercises the CONTROL plane, not content diversity.

    ``batch_submit=True`` drives the continuous-batching path: every live
    stream's chunk is SUBMITTED first (``submit_chunk``), then the whole
    round is flushed as cross-stream padded batches and polled — the mode
    that scales the soak to O(100) concurrent streams.  The default keeps
    the chunk-sequential PR-6 behavior bit-for-bit.

    ``forecast`` (a ``repro_torch.core.forecast.ForecastConfig``) arms
    PREDICTIVE admission: an EWMA forecaster tracks each stream's
    observed rate, and a chunk whose modeled transmission time at
    ``min(allocated, predicted)`` kbps would blow the deadline is
    withheld (``EdgeRuntime.hold_chunk`` — pipeline-③ hold on the carry)
    instead of transmitted into the collapse.  The reactive default
    (``forecast=None``) transmits and discovers the miss after the fact
    — behavior is byte-identical to pre-forecast builds.

    Everything that influences a decision is simulated/seeded, so two
    calls with the same inputs produce identical reports (minus wall
    time).  ``detector`` is the port's TinyDetector params (default: the
    port's ``init`` from seed ``cfg.seed + 1``); the frames come from the
    port's ``generate_chunk`` and stay on the device.  Runs on CUDA
    unless ``device`` says otherwise.
    """
    dev = resolve_device(device)
    C, T = cfg.n_streams, cfg.chunk_frames
    det_cfg = D.TinyDetectorConfig()
    params = detector if detector is not None else D.init(
        torch.Generator().manual_seed(cfg.seed + 1), det_cfg, device=dev)
    scfg = ServingConfig(n_streams=C, n_shards=cfg.n_shards,
                         gpu_capacity_fps=cfg.gpu_capacity_fps,
                         latency_budget=cfg.latency_budget)
    degrade = degrade or DegradeConfig(deadline_s=cfg.latency_budget)
    rt = EdgeRuntime(scfg, params, det_cfg, faults=schedule,
                     degrade=degrade,
                     # tight window/patience: the soak is short, so the
                     # detector must converge within a preset's window
                     straggler_cfg=DetectorConfig(patience=3, window=6),
                     device=dev)

    trace = generate_trace(TraceConfig(mean_kbps=cfg.mean_kbps,
                                       seed=cfg.seed), cfg.n_chunks)
    trace = apply_fault_profile(trace, schedule.bw_multipliers(cfg.n_chunks))

    forecaster = None
    if forecast is not None:
        forecaster = StreamForecaster(forecast, C)
    forecast_holds = 0

    def _group(c: int) -> int:
        return c % cfg.content_groups if cfg.content_groups else c

    frames = {g: generate_chunk(
        StreamConfig(height=cfg.height, width=cfg.width, n_objects=2,
                     seed=cfg.seed * 101 + g), 0, T, device=dev)[0]
        for g in sorted({_group(c) for c in range(C)})}
    packets: dict = {}

    def packet_for(c: int, level: int, bw: float):
        g = _group(c)
        if (g, level) not in packets:
            packets[(g, level)] = encode_hybrid(
                frames[g], bw, cfg.tr1, cfg.tr2, fps=cfg.fps, level=level,
                device=dev)
        return packets[(g, level)]

    delivered_fps = np.zeros(cfg.n_chunks)
    infer_fps = np.zeros(cfg.n_chunks)
    fps_norm = np.zeros(cfg.n_chunks)         # per-live-stream delivered
    infer_norm = np.zeros(cfg.n_chunks)       # per-live-stream inferred
    queue_leaks = []
    wall0 = time.perf_counter()
    for t in range(cfg.n_chunks):
        live = [c for c in range(C) if schedule.stream_active(c, t)]
        n_live = max(len(live), 1)
        alloc = float(trace[t]) / n_live
        delivered = inferred = 0
        round_ = []                    # (stream, ticket-or-types, packet)
        for c in live:
            if schedule.stalled(c, t):
                rt.note_stall(c, t)
                continue
            base = ladder_for_bandwidth(video_bandwidth_share(alloc))
            level = rt.suggest_level(c, base)
            pkt = packet_for(c, level, alloc)
            if forecaster is not None:
                # predictive admission: hold the chunk if the modeled
                # transmission at min(allocated, EWMA-predicted) kbps
                # would blow the deadline — don't transmit into a collapse
                pred_kbps = min(alloc, float(forecaster.predict_bw()[c]))
                t_tx = pkt.total_bits / max(pred_kbps * 1000.0, 1e-6)
                if t_tx > degrade.deadline_s:
                    tk = rt.hold_chunk(c, t, pkt)
                    forecast_holds += 1
                    round_.append(
                        (c, tk if batch_submit else rt.poll(tk)[2], pkt))
                    continue
            if batch_submit:
                round_.append((c, rt.submit_chunk(c, t, pkt), pkt))
            else:
                round_.append((c, rt.process_chunk(c, t, pkt)[2], pkt))
        if batch_submit:
            rt.flush()
        obs_bits = np.zeros(C, np.float32)
        obs_mask = np.zeros(C, bool)
        for c, item, pkt in round_:
            types = rt.poll(item)[2] if batch_submit else item
            st = rt.stats[c]
            bits = pkt.total_bits if st.last_transmitted else 0.0
            lat = rt.compute_latency(types, bits, alloc, stream=c)["total"] \
                + st.last_penalty_s
            rt.note_chunk_latency(c, t, lat)
            delivered += st.last_delivered
            inferred += st.last_inferred
            obs_bits[c] = bits
            obs_mask[c] = True
        if forecaster is not None:
            # every participating stream observed its announced allocation
            # (held ones too — the allocation is control-plane knowledge,
            # and a frozen EWMA would never see the link recover)
            forecaster.update(np.full(C, alloc, np.float32), obs_bits,
                              mask=obs_mask)
        rt.poll_faults(t)
        depth = float(rt.queues.depths.sum())
        if depth:
            queue_leaks.append((t, depth))
        delivered_fps[t] = delivered * cfg.fps / T
        infer_fps[t] = inferred * cfg.fps / T
        fps_norm[t] = delivered_fps[t] / n_live
        infer_norm[t] = infer_fps[t] / n_live
    wall = time.perf_counter() - wall0
    rt.close()                        # retire in-flight work, stop hedge pool

    stats = {c: rt.stats[c].as_dict() for c in sorted(rt.stats)}
    accounting_ok = all(
        s["frames_in"] == s["frames_inferred"] + s["frames_reused"]
        + s["frames_skipped"] for s in stats.values())
    disrupted = schedule.disruption_mask(cfg.n_chunks)
    return {
        "config": dataclasses.asdict(cfg),
        "n_chunks": cfg.n_chunks,
        "delivered_fps": delivered_fps,
        "infer_fps": infer_fps,
        "fps_norm": fps_norm,
        "infer_norm": infer_norm,
        "stream_stats": stats,
        "accounting_ok": accounting_ok,
        "queue_leaks": queue_leaks,
        "recovery": _recovery_report(fps_norm, disrupted, cfg),
        "recovery_infer": _recovery_report(infer_norm, disrupted, cfg),
        "fault_log": list(rt.fault_log),
        "active_shards_final": list(rt.active_shards),
        "hedged_dispatches": rt.hedged_dispatches,
        "forecast_holds": forecast_holds,
        "forecast_state": None if forecaster is None else forecaster.state(),
        "wall_s": wall,
    }
