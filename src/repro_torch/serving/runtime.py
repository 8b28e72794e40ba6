"""BiSwift edge serving runtime: decoder -> pipelines -> results (port of
``repro.serving.runtime``).

Binds the hybrid decoder's three pipelines to the scheduler's queues and
the detector, per chunk per stream: the paper's Fig. 4 right half.  The
runtime is a submit/flush/poll dispatcher in the style of LLM serving:

  * ``submit_chunk`` runs only host-side control (delivery ladder,
    admission, demotion, queue accounting), stages the chunk's execution
    planes and motion vectors on the device (``_stage_chunk``), and
    returns a :class:`ChunkTicket` without waiting for the device.  The
    frame types are host data; nothing is read back.
  * ``flush`` groups the pending tickets by (shard, T, H, W), gathers each
    group's pipeline-①/② rows (① before ②, submit order within each)
    into one detector batch of exactly those rows, dispatches it, and
    finishes every ticket with its scatter + pipeline-③ reuse on the
    device.  At most ``ServingConfig.max_inflight`` dispatched batches are
    outstanding per shard: past the cap the oldest one's CUDA event is
    waited on.  On the CPU dispatch is synchronous and the cap does
    nothing.
  * ``poll`` brings a ticket's boxes and scores to the host in ONE
    device-to-host copy.

``process_chunk`` is ``poll(submit_chunk(...))``.  Everything runs on one
CUDA stream a device.

Mesh mode (``mesh=``/``rules=``): the stream axis's extent on the mesh
sets the shard count, and shard i's detector has its own copy of the
params on mesh device i (mod the mesh's size): a dispatch moves its
payload there, and the batch's detections come back to the staging
device before the scatter and the carry.  Without a mesh, shards are
logical, all on the runtime's device.

The reference pads each detector batch to ``_pad_bucket(n, batch_size)``
rows and the ticket planes to a power of two, to bound XLA's trace cache;
PyTorch has none, so no padding is materialised.  The bucketed row count
still feeds the straggler detector and the simulated hedge, whose
decisions then follow the reference's.

Robustness plane: with ``faults=`` (a ``FaultSchedule``) the runtime
also runs the per-stream deadline-driven degradation ladder (retry with
backoff, rung demotion, forced pipeline-③ reuse, frame skip, every
decision in ``stats[stream]``), and straggler eviction with elastic
recovery of logical shards (``poll_faults``), hedging dispatches across
the active shards.  The invariant ``frames_in == frames_inferred +
frames_reused + frames_skipped`` is settled at submit time, from host
data, so it holds for every stream while its chunk is in flight.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque

import numpy as np
import torch

from repro_torch.codec.image_codec import ladder_bits
from repro_torch.codec.rate_model import QUALITY_LADDER, upscale_nearest
from repro_torch.core.hybrid_decoder import (PipelineCosts, _upscale_mvs,
                                             pipeline_cost)
from repro_torch.core.hybrid_encoder import HybridPacket
from repro_torch.core.reuse import reuse_chunk
from repro_torch.core.roi import region_grid, region_scores, roi_infer
from repro_torch.device import host_to_device, resolve_device
from repro_torch.distributed.stream_sharding import stream_shard_count
from repro_torch.models import detection as D
from repro_torch.serving.elastic import ElasticPool
from repro_torch.serving.scheduler import (AdmissionController, InferRequest,
                                           PipelineQueues, ServingConfig)
from repro_torch.serving.straggler import (DetectorConfig, HedgeConfig,
                                           HedgedExecutor, StragglerDetector)

f32 = np.float32


def _stage_chunk(types, anchor_hd, recon, mv, residual_q, *, hd_hw,
                 roi=None, anchor_search=False):
    """Stage one chunk on the device: upscale the LR video to analytics
    resolution, pick each frame's execution plane (the decoded HD anchor
    for type 1, the upscaled LR frame otherwise: type-2 frames get no
    quality transfer here, as in the reference), and upscale the motion
    vectors.  With ``roi`` the relevance head also scores each HD region,
    (T, R); with ``anchor_search`` the anchors' bits at every rung, (T,
    Q), one blockdct launch a rung.  Returns (frames, mvs, scores or None,
    rung bits or None)."""
    H, W = hd_hw
    lr_up = upscale_nearest(recon, H, W)
    frames = torch.where((types == 1)[:, None, None], anchor_hd, lr_up)
    mvs = _upscale_mvs(mv, (H, W))
    rung_bits = ladder_bits(anchor_hd) if anchor_search else None
    if roi is None:
        return frames, mvs, None, rung_bits
    nry, nrx = region_grid(hd_hw, roi)
    scores = region_scores(mv, residual_q, recon.shape[-2:], hd_hw, roi)
    return (frames, mvs, scores.reshape(types.shape[0], nry * nrx),
            rung_bits)


def _gather_batch(segments, n: int):
    """Pack the requested rows of the staged planes into one (n, ...)
    batch, in batch order: ``segments`` is [(plane (T, ...), row indices
    (k,) on the plane's device)].  Serves the frames and, in ROI mode,
    the region-score rows (the reference's ``_gather_batch`` and
    ``_gather_rows``); only the requested rows are copied."""
    first = segments[0][0]
    batch = first.new_empty((n, *first.shape[1:]))
    j = 0
    for plane, idx in segments:
        k = idx.shape[0]
        torch.index_select(plane, 0, idx, out=batch[j:j + k])
        j += k
    return batch


def _finish_chunk(types, pos, mvs, batch_boxes, batch_scores, init_b=None,
                  init_s=None):
    """Scatter one ticket's rows out of the batched detector output (row
    ``pos[t]`` for frame t, zeros where pos < 0) and run pipeline-③
    reuse from the carry; returns (boxes, scores, the new carry)."""
    mask = pos >= 0
    idx = pos.clamp(0, batch_boxes.shape[0] - 1).long()
    boxes_t = torch.where(mask[:, None, None], batch_boxes[idx], 0.0)
    scores_t = torch.where(mask[:, None], batch_scores[idx], 0.0)
    boxes, scores = reuse_chunk(types, mvs, boxes_t, scores_t,
                                init_boxes=init_b, init_scores=init_s)
    return boxes, scores, boxes[-1], scores[-1]


def _hold_chunk(last_b, last_s, *, T: int):
    """Zero-motion pipeline-③ hold for an undeliverable chunk with a
    carry: the previous detections repeated across the chunk."""
    return (last_b[None].expand(T, *last_b.shape),
            last_s[None].expand(T, *last_s.shape))


def _pad_bucket(n: int, base: int) -> int:
    """Smallest ``base * 2**k >= n``: the reference's detector batch size
    for n rows (the straggler accounting reads it)."""
    m = max(int(base), 1)
    while m < n:
        m *= 2
    return m


@dataclasses.dataclass
class StreamState:
    """Pipeline-③ carry across chunks, on the device."""
    last_boxes: torch.Tensor
    last_scores: torch.Tensor


@dataclasses.dataclass
class ChunkTicket:
    """Handle for one submitted chunk.  ``done`` flips when its device
    work is queued (dispatch + finish); ``poll`` brings the result to the
    host with one copy and caches it."""
    stream: int
    chunk_t: int
    shard: int
    types: np.ndarray
    hw: tuple
    reqs: list = dataclasses.field(default_factory=list)
    types_dev: torch.Tensor | None = None
    frames_dev: torch.Tensor | None = None
    mvs_dev: torch.Tensor | None = None
    rscores_dev: torch.Tensor | None = None   # (T, R) ROI scores (roi mode)
    # (T, Q) anchor bits at every rung (anchor_search mode): small, so
    # kept past dispatch for budget audits after poll
    rung_bits_dev: torch.Tensor | None = None
    init_b: torch.Tensor | None = None
    init_s: torch.Tensor | None = None
    n_cells: int = 0
    done: bool = False
    _dev_out: tuple | None = None      # (boxes, scores) on the device
    _host: tuple | None = None         # cached poll result


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Deadline ladder knobs (rungs in escalation order).

    1. retry-with-backoff: a lost/corrupt chunk is retransmitted up to
       ``max_retries`` times, backoff doubling from ``retry_backoff_s``,
       while the accumulated penalty still fits ``deadline_s``;
    2. rung demotion: ``demote_patience`` consecutive deadline misses
       drop the stream one bitrate-ladder rung (down to ``max_demotion``
       below its bandwidth-derived rung);
    3. pipeline-③ fallback: misses at the bottom rung force whole chunks
       onto motion-vector reuse (no inference);
    4. frame-skip: an undeliverable chunk with no carried detections is
       dropped with explicit accounting (types == 0).

    ``promote_patience`` consecutive on-deadline chunks walk the stream
    back up one step (reuse -> inference, then rung by rung).
    """
    deadline_s: float = 1.0
    max_retries: int = 3
    retry_backoff_s: float = 0.05
    demote_patience: int = 2
    promote_patience: int = 3
    max_demotion: int = len(QUALITY_LADDER) - 1


@dataclasses.dataclass
class StreamStats:
    """Per-stream degradation accounting: every ladder decision is
    surfaced here, nothing is silent."""
    stream: int
    frames_in: int = 0
    frames_inferred: int = 0          # pipelines ① and ② (through the DNN)
    frames_reused: int = 0            # pipeline ③
    frames_skipped: int = 0           # rung 4: explicitly dropped
    chunks: int = 0
    chunks_lost: int = 0
    chunks_corrupt: int = 0
    chunks_stalled: int = 0
    retries: int = 0
    deadline_misses: int = 0
    rung_demotion: int = 0            # current ladder demotion (0 = none)
    demote_events: int = 0
    promote_events: int = 0
    reuse_fallback_chunks: int = 0
    force_reuse: bool = False         # rung 3 engaged
    events: list = dataclasses.field(default_factory=list)
    # transient per-chunk fields (the soak reads them right after a chunk)
    last_penalty_s: float = 0.0
    last_transmitted: bool = True
    last_delivered: int = 0
    last_inferred: int = 0
    last_skipped: int = 0
    _miss_streak: int = 0
    _ok_streak: int = 0

    def note(self, t: int, action: str, detail: str = ""):
        self.events.append((int(t), action, detail))

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["events"] = [list(e) for e in d["events"]]
        return {k: v for k, v in d.items() if not k.startswith("_")}


class EdgeRuntime:
    def __init__(self, cfg: ServingConfig, detector_params, det_cfg,
                 costs: PipelineCosts = PipelineCosts(), *,
                 mesh=None, rules=None, faults=None,
                 degrade: DegradeConfig | None = None,
                 hedge: HedgeConfig | None = None,
                 straggler_cfg: DetectorConfig | None = None, device=None):
        """``mesh``/``rules`` (a :class:`~repro_torch.distributed.mesh.Mesh`
        and an ``AxisRules`` with a "stream" entry) switch the runtime to
        mesh mode: n_shards is the mesh's stream extent, streams map to
        shards round-robin, each dispatch drains only its own shard's
        queues, and shard i's detector runs on mesh device i (its params
        copied once a distinct device).  Chunks are staged on ``device``,
        by default the mesh's first device in mesh mode and CUDA
        otherwise.

        ``faults`` (a ``FaultSchedule``) arms the chaos plane: the
        degradation ladder (``degrade``), hedged dispatch (``hedge``) and
        straggler eviction (``straggler_cfg``) all activate; without it
        the runtime serves plainly (stats still collected).
        ``cfg.n_shards > 1`` without a mesh gives logical shards on the
        one device, each with its slice of the capacity."""
        if (mesh is None) != (rules is None):
            raise ValueError("mesh mode needs BOTH mesh= and rules= (got "
                             "only one)")
        if mesh is not None:
            cfg = dataclasses.replace(
                cfg, n_shards=stream_shard_count(mesh, rules))
            if device is None:
                device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_shards = max(cfg.n_shards, 1)
        self.det_cfg = det_cfg
        self.costs = costs

        # in ROI mode the dispatch payload is (frames, region scores) and
        # each row runs only its top-K gated region patches
        roi = getattr(cfg, "roi", None)

        def make_infer(params, dev=None):
            # a shard's replica moves the payload to its own device: the
            # hedge's backup gets the primary's staged batch
            def to_dev(x):
                return x if dev is None else x.to(dev, non_blocking=True)

            if roi is None:
                def infer(frames):
                    return D.decode_boxes(
                        D.forward(params, det_cfg, to_dev(frames)), det_cfg)
            else:
                def infer(payload):
                    return roi_infer(params, det_cfg, roi,
                                     to_dev(payload[0]), to_dev(payload[1]))
            return infer

        placed = {}     # the params once a distinct device

        def params_on(dev):
            if dev not in placed:
                placed[dev] = {k: torch.as_tensor(v).to(dev)
                               for k, v in detector_params.items()}
            return placed[dev]

        self.roi = roi
        self.anchor_search = bool(getattr(cfg, "anchor_search", False))
        self._infer = make_infer(params_on(self.device))
        # mesh mode: shard i's detector on mesh device i
        self._shard_infer: list | None = None
        if mesh is not None and self.n_shards > 1:
            devs = list(mesh.devices.flat)
            shard_devs = [devs[i % len(devs)] for i in range(self.n_shards)]
            replicas = {dev: make_infer(params_on(dev), dev)
                        for dev in dict.fromkeys(shard_devs)}
            self._shard_infer = [replicas[dev] for dev in shard_devs]
        self.queues = PipelineQueues(cfg, self._infer_batch)
        self.admission = AdmissionController(cfg)
        self.streams: dict[int, StreamState] = {}
        self.deferred = 0
        self.deferred_by_shard = np.zeros(self.n_shards, np.int64)
        # pipeline-③ fallback accounting: frames demoted ②->③ under
        # overload, and whole chunks forced onto reuse (deep overload)
        self.demoted_frames = np.zeros(self.n_shards, np.int64)
        self.reuse_fallback_chunks = np.zeros(self.n_shards, np.int64)

        # ------------------------------------------ async dispatch plane
        self.max_inflight = max(int(getattr(cfg, "max_inflight", 2)), 1)
        self._pending: list[ChunkTicket] = []     # submitted, undispatched
        self._open: dict[int, ChunkTicket] = {}   # stream -> pending ticket
        # per shard: a CUDA event recorded after each dispatch (None on
        # the CPU, where dispatch is synchronous)
        self._inflight: dict[int, deque] = defaultdict(deque)

        # ---------------------------------------------- robustness plane
        self.faults = faults
        self.degrade = degrade or DegradeConfig(
            deadline_s=cfg.latency_budget)
        self.stats: dict[int, StreamStats] = {}
        self.active_shards: list[int] = list(range(self.n_shards))
        self.pool = ElasticPool(self.n_shards)
        self.straggler = StragglerDetector(
            straggler_cfg or DetectorConfig(), self.n_shards)
        self._hedge_cfg = hedge or HedgeConfig()
        self._hedge: HedgedExecutor | None = None
        if self.n_shards > 1 and (faults is not None or hedge is not None):
            self._rebuild_hedge()
        self.fault_log: list[tuple[int, str, str]] = []
        self._t = 0

    # ------------------------------------------------------------------
    def stream_shard(self, stream: int) -> int:
        """Owning shard for a stream: round-robin over the currently
        active shards, so eviction re-homes streams onto survivors."""
        return self.active_shards[stream % len(self.active_shards)]

    def _shard_fn(self, shard: int | None):
        """The detector a dispatch of ``shard`` runs: its own in mesh
        mode, else the runtime's one."""
        return self._infer if self._shard_infer is None or shard is None \
            else self._shard_infer[shard]

    def _rebuild_hedge(self):
        old = self._hedge
        self._hedge = HedgedExecutor(
            self._hedge_cfg, [self._shard_fn(s) for s in self.active_shards])
        if old is not None:
            self._hedge.lat.extend(old.lat)
            self._hedge.hedges = old.hedges
            old.close()

    @property
    def hedged_dispatches(self) -> int:
        return 0 if self._hedge is None else self._hedge.hedges

    def _infer_batch_dev(self, frames, shard=None, n_rows=None):
        """Detector dispatch returning DEVICE tensors ``(boxes, scores)``,
        on the shard's device in mesh mode (else the runtime's); nothing
        here waits for the device.  With a fault schedule armed,
        the dispatch's simulated step time (``n_rows`` rows at the shard's
        capacity, times the schedule's slowdown) feeds the straggler
        detector, and the call hedges across the active shards when the
        primary would blow the latency-quantile deadline."""
        if shard is not None and self.faults is not None:
            if n_rows is None:
                n_rows = frames[0].shape[0] if isinstance(frames, tuple) \
                    else frames.shape[0]
            base = n_rows / max(self.cfg.shard_capacity_fps, 1e-6)
            slow = self.faults.shard_slowdown(shard, self._t)
            self.straggler.record(shard, base * slow)
            if self._hedge is not None and len(self.active_shards) > 1 \
                    and shard in self.active_shards:
                idx = self.active_shards.index(shard)

                def sim(i):
                    return base * self.faults.shard_slowdown(
                        self.active_shards[i], self._t)

                out, _ = self._hedge.run(frames,
                                         simulate_latency=sim, primary=idx)
                return out
        return self._shard_fn(shard)(frames)

    def _infer_batch(self, frames, shard=None):
        """Legacy host-facing executor (``PipelineQueues.drain_fused``):
        host frames in, the dispatch, then each row's (boxes, scores) as
        host arrays."""
        if self.roi is not None:
            raise RuntimeError(
                "the legacy frame-payload drain cannot run in ROI mode: "
                "region scores are staged per ticket; use "
                "submit_chunk/flush/poll (process_chunk)")
        boxes, scores = self._infer_batch_dev(
            host_to_device(frames, self.device, torch.float32), shard)
        return list(zip(boxes.cpu().numpy(), scores.cpu().numpy()))

    # ------------------------------------------------- degradation ladder
    def _stats(self, stream: int) -> StreamStats:
        if stream not in self.stats:
            self.stats[stream] = StreamStats(stream)
        return self.stats[stream]

    def suggest_level(self, stream: int, base_level: int) -> int:
        """Ladder rung the stream should encode at: its bandwidth-derived
        rung minus any deadline-driven demotion (rung 2)."""
        st = self._stats(stream)
        return max(int(base_level) - st.rung_demotion, 0)

    def note_stall(self, stream: int, t: int):
        st = self._stats(stream)
        st.chunks_stalled += 1
        st.note(t, "stall", "camera produced no chunk")

    def note_chunk_latency(self, stream: int, t: int, latency_s: float):
        """Feed one chunk's end-to-end latency into the ladder controller:
        consecutive deadline misses demote (rung 2) then force reuse
        (rung 3); consecutive on-deadline chunks walk back up."""
        st = self._stats(stream)
        d = self.degrade
        if latency_s > d.deadline_s:
            st.deadline_misses += 1
            st._miss_streak += 1
            st._ok_streak = 0
            if st._miss_streak >= d.demote_patience:
                st._miss_streak = 0
                if st.rung_demotion < d.max_demotion:
                    st.rung_demotion += 1
                    st.demote_events += 1
                    st.note(t, "demote",
                            f"latency {latency_s:.3f}s > deadline; "
                            f"rung -{st.rung_demotion}")
                elif not st.force_reuse:
                    st.force_reuse = True
                    st.note(t, "force_reuse",
                            "bottom rung still missing deadline")
        else:
            st._ok_streak += 1
            st._miss_streak = 0
            if st._ok_streak >= d.promote_patience:
                st._ok_streak = 0
                if st.force_reuse:
                    st.force_reuse = False
                    st.note(t, "resume_infer", "deadline met; leaving "
                            "pipeline-3 fallback")
                elif st.rung_demotion > 0:
                    st.rung_demotion -= 1
                    st.promote_events += 1
                    st.note(t, "promote", f"rung -{st.rung_demotion}")

    def _deliver(self, stream: int, t: int) -> bool:
        """Rung 1: was the chunk's payload delivered (possibly after
        retries)?  Retransmissions traverse the same degraded link and
        each backoff eats deadline budget; the accumulated backoff is
        charged to the chunk via ``last_penalty_s``."""
        st = self.stats[stream]
        f, d = self.faults, self.degrade
        lost = f.chunk_lost(stream, t)
        corrupt = f.chunk_corrupt(stream, t)
        if not (lost or corrupt):
            return True
        if lost:
            st.chunks_lost += 1
        if corrupt:
            st.chunks_corrupt += 1
        penalty = 0.0
        for attempt in range(d.max_retries):
            backoff = d.retry_backoff_s * (2 ** attempt)
            if penalty + backoff > d.deadline_s:
                break
            penalty += backoff
            st.retries += 1
            if f.retry_succeeds(stream, t, attempt):
                st.last_penalty_s = penalty
                st.note(t, "retry_ok",
                        f"attempt {attempt + 1}, +{penalty:.3f}s")
                return True
        st.last_penalty_s = penalty
        st.note(t, "retry_exhausted",
                f"{'lost' if lost else 'corrupt'} chunk undeliverable")
        return False

    def _n_cells(self, H: int, W: int) -> int:
        return (H // self.det_cfg.stride) * (W // self.det_cfg.stride)

    def _skip_chunk(self, stream: int, t: int,
                    packet: HybridPacket) -> ChunkTicket:
        """Rungs 3/4 for an undeliverable chunk: hold the previous
        detections (zero-motion pipeline-③) when a carry exists, else
        drop the chunk with explicit accounting (types == 0).  The carry
        stays on the device; the hold is a broadcast, not a copy."""
        st = self.stats[stream]
        T = packet.types.shape[0]
        H, W = packet.anchor_hd.shape[1:]
        n_cells = self._n_cells(H, W)
        prev = self.streams.get(stream)
        tk = ChunkTicket(stream, t, self.stream_shard(stream),
                         np.zeros(T, packet.types.dtype), (H, W),
                         n_cells=n_cells, done=True)
        if prev is not None and prev.last_boxes.shape[0] == n_cells:
            tk.types = np.full(T, 3, packet.types.dtype)
            tk._dev_out = _hold_chunk(prev.last_boxes, prev.last_scores,
                                      T=T)
            st.frames_reused += T
            st.reuse_fallback_chunks += 1
            st.last_delivered = T
            st.note(t, "reuse_hold",
                    f"{T} frames held on carried detections")
            return tk
        st.frames_skipped += T
        st.last_skipped = T
        st.note(t, "frame_skip", f"{T} frames dropped (no carry)")
        tk._host = (np.zeros((T, n_cells, 4), f32),
                    np.zeros((T, n_cells), f32), tk.types)
        return tk

    def hold_chunk(self, stream: int, t: int,
                   packet: HybridPacket) -> ChunkTicket:
        """Predictive admission: withhold a chunk the forecast says the
        link cannot deliver inside the deadline, BEFORE transmitting it.
        Same degradation semantics as an undeliverable chunk (pipeline-③
        hold on the carried detections, frame-skip without a carry), but
        entered proactively by the caller's bandwidth forecast: no bits
        are charged and no deadline penalty accrues.  Accounting mirrors
        ``submit_chunk`` (frames_in grows; the invariant holds)."""
        self._t = t
        st = self._stats(stream)
        T = packet.types.shape[0]
        st.chunks += 1
        st.frames_in += T
        st.last_penalty_s = 0.0
        st.last_transmitted = False
        st.last_delivered = st.last_inferred = st.last_skipped = 0
        st.note(t, "forecast_hold",
                "predicted bandwidth below deadline; chunk withheld")
        return self._skip_chunk(stream, t, packet)

    # --------------------------------------------------- submit/flush/poll
    def submit_chunk(self, stream: int, t: int,
                     packet: HybridPacket) -> ChunkTicket:
        """Non-blocking admission of one chunk: run the host-side control
        ladder (delivery retries, forced reuse, admission/demotion), stage
        the chunk's execution planes on the device, enqueue its
        pipeline-①/② requests, and return a :class:`ChunkTicket`.  Reads
        nothing back from the device.

        Per-stream ordering: submitting a stream's next chunk while its
        previous ticket is still pending first flushes, so the
        pipeline-③ carry chain stays ordered."""
        self._t = t
        prev_tk = self._open.get(stream)
        if prev_tk is not None and not prev_tk.done:
            self.flush()

        st = self._stats(stream)
        T = packet.types.shape[0]
        st.chunks += 1
        st.frames_in += T
        st.last_penalty_s = 0.0
        st.last_transmitted = True
        st.last_delivered = st.last_inferred = st.last_skipped = 0

        if self.faults is not None and not self._deliver(stream, t):
            st.last_transmitted = False
            return self._skip_chunk(stream, t, packet)

        enc = packet.video
        H, W = packet.anchor_hd.shape[1:]
        types = packet.types.copy()
        prev = self.streams.get(stream)
        shard = self.stream_shard(stream)

        if st.force_reuse and prev is not None:
            # rung 3: ladder floor exhausted; the whole chunk on pipeline
            # ③ with the packet's real motion vectors (the payload arrived)
            types = np.full_like(types, 3)
            st.reuse_fallback_chunks += 1
            self.reuse_fallback_chunks[shard] += 1
            st.note(t, "reuse_chunk", "forced pipeline-3 chunk")

        n_infer = int((types != 3).sum())
        if n_infer and not self.admission.admit_shard(
                self.queues.shard_depths, shard, n_infer):
            # overload: demote transfer frames to reuse, keep the anchors
            self.demoted_frames[shard] += int((types == 2).sum())
            types = np.where(types == 2, 3, types)
            self.deferred += 1
            self.deferred_by_shard[shard] += 1
            st.note(t, "defer", "shard overloaded; type-2 frames demoted")
            # deep overload: if even anchors-only blows the budget AND
            # there are carried detections to reuse, the whole chunk runs
            # on pipeline ③
            if prev is not None and \
                    not self.admission.admit_shard(self.queues.shard_depths,
                                                   shard,
                                                   int((types != 3).sum())):
                self.demoted_frames[shard] += int((types != 3).sum())
                types = np.full_like(types, 3)
                self.reuse_fallback_chunks[shard] += 1
                st.reuse_fallback_chunks += 1
                st.note(t, "reuse_chunk", "deep overload")

        dev = self.device
        types_dev = host_to_device(types, dev, torch.int32)
        frames_dev, mvs_dev, rscores_dev, rung_bits_dev = _stage_chunk(
            types_dev, packet.anchor_hd.to(dev), enc.recon.to(dev),
            enc.mv.to(dev), enc.residual_q.to(dev), hd_hw=(H, W),
            roi=self.roi, anchor_search=self.anchor_search)

        tk = ChunkTicket(stream, t, shard, types, (H, W),
                         types_dev=types_dev, frames_dev=frames_dev,
                         mvs_dev=mvs_dev, rscores_dev=rscores_dev,
                         rung_bits_dev=rung_bits_dev,
                         init_b=None if prev is None else prev.last_boxes,
                         init_s=None if prev is None else prev.last_scores,
                         n_cells=self._n_cells(H, W))
        for i in range(T):
            if types[i] in (1, 2):
                req = InferRequest(stream, t, int(i), int(types[i]),
                                   None, shard=shard)
                self.queues.submit(req)
                tk.reqs.append(req)

        n_inf = int(((types == 1) | (types == 2)).sum())
        st.frames_inferred += n_inf
        st.frames_reused += int((types == 3).sum())
        st.last_inferred = n_inf
        st.last_delivered = T
        self._pending.append(tk)
        self._open[stream] = tk
        return tk

    def _retire(self, shard: int, keep: int):
        """Wait for the oldest dispatched batches of ``shard`` until at
        most ``keep`` are outstanding."""
        q = self._inflight[shard]
        while len(q) > keep:
            event = q.popleft()
            if event is not None:
                event.synchronize()

    def _dispatch_group(self, shard: int, tickets: list[ChunkTicket]):
        """Dispatch one (shard, T, H, W) group: gather every ticket's
        pipeline-①/② rows into one batch (① rows before ②, submit order
        within each), run the detector under the in-flight cap, and
        finish each ticket's scatter + reuse on the device."""
        T = int(tickets[0].types.shape[0])
        by_stream = {tk.stream: tk for tk in tickets}
        reqs = [r for tk in tickets for r in tk.reqs if r.pipeline == 1] \
            + [r for tk in tickets for r in tk.reqs if r.pipeline == 2]
        self.queues.take(reqs)
        dev = self.device

        bb = bs = None
        if reqs:
            # consecutive requests of one ticket form one segment
            runs = []
            for r in reqs:
                if runs and runs[-1][0] == r.stream:
                    runs[-1][1].append(r.frame_idx)
                else:
                    runs.append((r.stream, [r.frame_idx]))
            rows = [host_to_device(np.asarray(ids, np.int64), dev)
                    for _, ids in runs]
            batch = _gather_batch([(by_stream[s].frames_dev, idx)
                                   for (s, _), idx in zip(runs, rows)],
                                  len(reqs))
            if self.roi is not None:
                batch = (batch, _gather_batch(
                    [(by_stream[s].rscores_dev, idx)
                     for (s, _), idx in zip(runs, rows)], len(reqs)))
            self._retire(shard, self.max_inflight - 1)
            bb, bs = self._infer_batch_dev(
                batch, shard=shard,
                n_rows=_pad_bucket(len(reqs), self.cfg.batch_size))
            event = None
            if bb.device.type == "cuda":
                # on the device that ran the batch: the shard's in mesh mode
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(bb.device))
            self._inflight[shard].append(event)
            # finish on the staging device: the carry lives on ONE device
            # whichever shard (or hedge replica) ran the batch
            bb, bs = bb.to(dev), bs.to(dev)

        for tk in tickets:
            pos = np.full(T, -1, np.int32)
            for j, r in enumerate(reqs):
                if r.stream == tk.stream:
                    pos[r.frame_idx] = j
            if bb is None:
                dbb = torch.zeros((1, tk.n_cells, 4), device=dev)
                dbs = torch.zeros((1, tk.n_cells), device=dev)
            else:
                dbb, dbs = bb, bs
            boxes, scores, last_b, last_s = _finish_chunk(
                tk.types_dev, host_to_device(pos, dev), tk.mvs_dev, dbb, dbs,
                tk.init_b, tk.init_s)
            self.streams[tk.stream] = StreamState(last_b, last_s)
            tk._dev_out = (boxes, scores)
            tk.done = True
            tk.frames_dev = tk.mvs_dev = tk.init_b = tk.init_s = None
            tk.rscores_dev = tk.types_dev = None
            if self._open.get(tk.stream) is tk:
                del self._open[tk.stream]

    def flush(self, shard: int | None = None):
        """Dispatch every pending ticket (optionally one shard's):
        continuous batching, the tickets submitted since the last flush
        form the next signature groups while earlier batches may still be
        computing on the device."""
        todo = [tk for tk in self._pending
                if not tk.done and (shard is None or tk.shard == shard)]
        groups: dict[tuple, list[ChunkTicket]] = {}
        for tk in todo:
            key = (tk.shard, int(tk.types.shape[0]), *tk.hw)
            groups.setdefault(key, []).append(tk)
        for key in sorted(groups):
            self._dispatch_group(key[0], groups[key])
        self._pending = [tk for tk in self._pending if not tk.done]

    def poll(self, ticket: ChunkTicket):
        """Wait for the ticket's chunk and return per-frame ``(boxes,
        scores, types)`` as host arrays: boxes and scores cross in ONE
        device-to-host copy (as views of one (T, N, 5) array)."""
        if ticket._host is None:
            if not ticket.done:
                self.flush()
            boxes, scores = ticket._dev_out
            host = torch.cat([boxes, scores[..., None]], -1).cpu().numpy()
            ticket._host = (host[..., :4], host[..., 4], ticket.types)
            ticket._dev_out = None
        return ticket._host

    def poll_all(self, tickets):
        """Flush once, then bring every ticket to the host."""
        self.flush()
        return [self.poll(tk) for tk in tickets]

    # ------------------------------------------------------------------
    def process_chunk(self, stream: int, t: int, packet: HybridPacket):
        """Synchronous convenience wrapper: submit + flush + poll one
        chunk.  Returns per-frame (boxes, scores, types).

        All pipeline-①/② frames of the chunk go through ONE detector
        call on the stream's own shard; admission reads that shard's
        queue depths before the chunk is enqueued, and pipeline ③ carries
        the previous chunk's last detections across the chunk boundary.
        With a fault schedule armed, the chunk first runs the delivery
        ladder, and returned ``types`` may contain 0 (skipped frames)."""
        return self.poll(self.submit_chunk(stream, t, packet))

    def close(self):
        """Tear down the dispatch plane: retire in-flight batches and shut
        the hedge executor's thread pool.  Idempotent."""
        for shard in list(self._inflight):
            self._retire(shard, 0)
        if self._hedge is not None:
            self._hedge.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -------------------------------------------- eviction and recovery
    def evict_shard(self, shard: int, t: int, reason: str = "straggler"):
        """Remove a shard from service: queued requests AND pending
        tickets re-home onto survivor shards; future ``stream_shard``
        routing skips it.  Batches already dispatched are kept.  The LAST
        shard is never evicted."""
        if shard not in self.active_shards or len(self.active_shards) <= 1:
            return False
        self.pool.fail(shard)
        self.active_shards.remove(shard)
        moved = self.queues.remap_shards(self.stream_shard)
        for tk in self._pending:
            if not tk.done:
                tk.shard = self.stream_shard(tk.stream)
        self.straggler.reset(shard)
        if self._hedge is not None:
            self._rebuild_hedge()
        self.fault_log.append(
            (int(t), "evict",
             f"shard {shard} ({reason}); {moved} queued requests re-homed; "
             f"survivors {self.active_shards}"))
        return True

    def recover_shard(self, shard: int, t: int):
        if shard in self.active_shards or not 0 <= shard < self.n_shards:
            return False
        self.pool.recover(shard)
        self.active_shards = sorted(self.active_shards + [shard])
        self.straggler.reset(shard)
        if self._hedge is not None:
            self._rebuild_hedge()
        self.fault_log.append(
            (int(t), "recover",
             f"shard {shard} re-admitted; active {self.active_shards}"))
        return True

    def poll_faults(self, t: int):
        """Once-per-chunk control step: evict the shards the straggler
        detector flags; re-admit evicted shards once the fault schedule
        reports them healthy (slowdown back to 1.0)."""
        self._t = t
        for shard in self.straggler.flagged():
            self.evict_shard(shard, t)
        if self.faults is not None:
            for g in range(self.n_shards):
                if g not in self.active_shards and \
                        self.faults.shard_slowdown(g, t) <= 1.0:
                    self.recover_shard(g, t)

    # ------------------------------------------------------------------
    def compute_latency(self, types: np.ndarray, bits: float,
                        bw_kbps: float, stream: int | None = None) -> dict:
        """Latency model for one chunk.  With ``stream`` given, queueing
        delay comes from that stream's shard backlog against the shard's
        capacity slice (the global estimate at n_shards=1)."""
        n1 = int((types == 1).sum())
        n2 = int((types == 2).sum())
        n3 = int((types == 3).sum())
        t_comp = pipeline_cost(n1, n2, n3, self.costs)
        if stream is None:
            t_queue = float(self.queues.depths.sum()) \
                / self.cfg.gpu_capacity_fps
        else:
            shard = self.stream_shard(stream)
            t_queue = float(self.queues.shard_depths[shard].sum()) \
                / self.cfg.shard_capacity_fps
        t_trans = bits / max(bw_kbps * 1000.0, 1e-6)
        return {"t_trans": t_trans, "t_queue": t_queue, "t_comp": t_comp,
                "total": t_trans + t_queue + t_comp}
