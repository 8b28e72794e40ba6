"""Multi-stream serving scheduler, BiSwift's edge runtime control plane
(port of ``repro.serving.scheduler``: the same numpy code).

Chunk-granular event loop over C streams:
  * admission control: streams whose queue exceeds the latency budget are
    deferred (their packets fall back to pipeline ③ reuse — cheap),
  * pipeline queues: ①(infer) and ②(transfer+infer) feed the batched DNN
    executor; ③ bypasses the DNN (paper Fig. 6),
  * batching: inference requests across streams are batched to the DNN's
    preferred batch (amortizes launches),
  * the bandwidth controller is invoked every ``controller_interval``
    chunks with the global S_high state (paper: 10 s).
"""
from __future__ import annotations

import dataclasses
import inspect
from collections import deque
from typing import Callable, Optional

import numpy as np

f32 = np.float32


@dataclasses.dataclass
class ServingConfig:
    n_streams: int
    batch_size: int = 8              # DNN executor batch
    gpu_capacity_fps: float = 120.0  # AGGREGATE edge DNN throughput
    latency_budget: float = 1.0
    controller_interval: int = 10
    # how many ways the stream axis is sharded over the device mesh
    # (stream sharding).  Streams map to shards
    # round-robin (stream % n_shards); each shard owns an equal slice of
    # gpu_capacity_fps and admits against its OWN queue depth, so a hot
    # shard defers its streams to pipeline-③ reuse instead of stalling
    # the global batch.
    n_shards: int = 1
    # double-buffered chunk slots: how many dispatched detector batches
    # may be outstanding per shard before the runtime retires the oldest
    # (EdgeRuntime.flush) — 2 overlaps host scheduling of the next batch
    # with the device computing the current one
    max_inflight: int = 2
    # optional repro_torch.core.roi.RoiConfig: the detector gates each
    # batch row onto its top-K active regions (scored at stage time from
    # the codec's macroblock statistics).  None = full-frame inference.
    roi: object | None = None
    # in-trace anchor-quality budget search: when True the async stage
    # step additionally stages the per-rung anchor bit planes
    # (EdgeRuntime._stage_chunk) so a downstream budget pick needs no
    # extra host round trip — submit stays non-blocking either way
    anchor_search: bool = False

    @property
    def shard_capacity_fps(self) -> float:
        return self.gpu_capacity_fps / max(self.n_shards, 1)


@dataclasses.dataclass
class InferRequest:
    stream: int
    chunk_t: int
    frame_idx: int
    pipeline: int                    # 1 or 2
    # the frame payload, or None for a LIGHTWEIGHT request whose frames
    # are already staged on device (EdgeRuntime.submit_chunk): the queue
    # entry then carries only the accounting/routing state (depths,
    # admission, shard remap) and the owner gathers the staged plane at
    # dispatch time.  ``drain``/``drain_fused`` require real frames.
    frame: Optional[np.ndarray]
    shard: int = 0                   # owning mesh shard (stream % n_shards)


class PipelineQueues:
    """Queues for pipelines ① and ② + shared batched execution."""

    def __init__(self, cfg: ServingConfig, infer_fn: Callable):
        self.cfg = cfg
        self.q1: deque = deque()
        self.q2: deque = deque()
        self.infer_fn = infer_fn
        # shard-aware executors (EdgeRuntime in sharded mode) take the
        # drained shard so the dispatch lands on that shard's device;
        # plain ``f(frames)`` executors keep working unchanged.  A
        # ``**kwargs`` wrapper around a shard-aware executor counts too.
        try:
            params = inspect.signature(infer_fn).parameters.values()
            self._infer_takes_shard = any(
                p.name == "shard" or p.kind is p.VAR_KEYWORD
                for p in params)
        except (TypeError, ValueError):
            self._infer_takes_shard = False

    def submit(self, req: InferRequest):
        (self.q1 if req.pipeline == 1 else self.q2).append(req)

    @property
    def depths(self) -> np.ndarray:
        return np.asarray([len(self.q1), len(self.q2)], f32)

    @property
    def shard_depths(self) -> np.ndarray:
        """(n_shards, 2) queued-request counts per mesh shard.  Row i is
        the backlog in front of device shard i only — the admission signal
        when the stream axis is sharded (a hot shard must defer ITS
        streams without penalizing streams placed on idle shards)."""
        d = np.zeros((max(self.cfg.n_shards, 1), 2), f32)
        for req in self.q1:
            d[req.shard, 0] += 1.0
        for req in self.q2:
            d[req.shard, 1] += 1.0
        return d

    def drain_fused(self, pad_multiple: Optional[int] = None,
                    shard: Optional[int] = None):
        """Execute queued requests (① before ②) as ONE padded invocation
        of ``infer_fn`` — one device dispatch per chunk.

        ``shard`` restricts the drain to that mesh shard's requests (the
        per-shard detector dispatch of the sharded runtime); other shards'
        backlogs stay queued.  The stacked batch is zero-padded up to the
        next multiple of ``pad_multiple`` (default: the configured batch
        size) so the detector sees a small, fixed set of shapes and its
        jit cache stays warm across chunks with different type mixes.
        """
        if shard is None:
            batch = list(self.q1) + list(self.q2)
            self.q1.clear()
            self.q2.clear()
        else:
            batch = [r for r in self.q1 if r.shard == shard] \
                + [r for r in self.q2 if r.shard == shard]
            self.q1 = deque(r for r in self.q1 if r.shard != shard)
            self.q2 = deque(r for r in self.q2 if r.shard != shard)
        if not batch:
            return []
        pad = max(pad_multiple or self.cfg.batch_size, 1)
        n = len(batch)
        n_pad = -(-n // pad) * pad
        frames = np.stack([r.frame for r in batch]
                          + [np.zeros_like(batch[0].frame)] * (n_pad - n))
        if self._infer_takes_shard:
            outs = self.infer_fn(frames, shard=shard)[:n]
        else:
            outs = self.infer_fn(frames)[:n]
        return list(zip(batch, outs))

    def take(self, reqs) -> int:
        """Remove specific queued requests (by identity) WITHOUT executing
        them — the async dispatcher gathers their staged device frames
        itself (``EdgeRuntime._dispatch_group``) and only needs the queue
        to forget them.  Requests not queued here are ignored.  Returns
        the number removed."""
        ids = {id(r) for r in reqs}
        n0 = len(self.q1) + len(self.q2)
        self.q1 = deque(r for r in self.q1 if id(r) not in ids)
        self.q2 = deque(r for r in self.q2 if id(r) not in ids)
        return n0 - len(self.q1) - len(self.q2)

    def remap_shards(self, mapper: Callable[[int], int]) -> int:
        """Rewrite every queued request's owning shard via
        ``mapper(stream) -> shard``.  Called after a shard eviction so
        in-flight requests follow their streams onto the survivor shards
        instead of waiting on a device that will never drain them.
        Returns the number of requests whose shard changed."""
        moved = 0
        for q in (self.q1, self.q2):
            for req in q:
                new = int(mapper(req.stream))
                if new != req.shard:
                    req.shard = new
                    moved += 1
        return moved

    def drain(self, max_frames: Optional[int] = None):
        """Execute queued requests in batches (priority: ① then ②)."""
        done = []
        budget = max_frames if max_frames is not None else 1 << 30
        while budget > 0 and (self.q1 or self.q2):
            batch = []
            while len(batch) < min(self.cfg.batch_size, budget) and \
                    (self.q1 or self.q2):
                batch.append(self.q1.popleft() if self.q1
                             else self.q2.popleft())
            frames = np.stack([r.frame for r in batch])
            outs = self.infer_fn(frames)
            for r, o in zip(batch, outs):
                done.append((r, o))
            budget -= len(batch)
        return done


class AdmissionController:
    """Defers streams whose backlog would blow the latency budget."""

    def __init__(self, cfg: ServingConfig):
        self.cfg = cfg

    def admit(self, queue_depths: np.ndarray, n_new_infer: int) -> bool:
        """Global admission: total backlog vs aggregate capacity."""
        backlog = float(queue_depths.sum()) + n_new_infer
        est_delay = backlog / self.cfg.gpu_capacity_fps
        return est_delay <= self.cfg.latency_budget

    def admit_shard(self, shard_depths: np.ndarray, shard: int,
                    n_new_infer: int) -> bool:
        """Per-shard admission: the stream's OWN shard backlog vs that
        shard's slice of capacity.  Identical to :meth:`admit` when
        n_shards == 1; with a sharded mesh, a stream lands on pipeline-③
        reuse exactly when ITS device is hot — idle shards keep admitting
        regardless of the global backlog."""
        backlog = float(np.asarray(shard_depths)[shard].sum()) + n_new_infer
        est_delay = backlog / self.cfg.shard_capacity_fps
        return est_delay <= self.cfg.latency_budget
