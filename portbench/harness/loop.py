"""The closed loop of chunks and their read-back.

The main thread submits chunk after chunk through the program's entry.
Each chunk's outputs are then copied on a stream of their own into pinned
host buffers, so that the copy overlaps the next chunk's work; a reader
thread waits for each copy and stamps the chunk done when its outputs are
on the host.  At most INFLIGHT chunks are submitted and not yet read
back: the main thread waits for one to be read back before it submits.

A chunk's completion time is its copy's end on the device's clock, laid
onto the host's clock by an event recorded when the run starts: the
reader thread's wake-up, which waits for the interpreter lock, does not
move it.

A seeded reservoir keeps the outputs of KEEP of the chunks read back,
a uniform sample of them, for the comparison with the reference: a kept
chunk keeps its buffers, the one it replaces gives them back.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function


@dataclasses.dataclass
class Chunk:
    index: int
    t_submit: float
    t_return: float = 0.0
    t_done: float = 0.0
    counts: object = None       # (S, 3) frames of types 1, 2, 3
    host: dict | None = None    # the read-back outputs, while kept
    out: dict | None = None     # the outputs on the device, until copied
    event: object = None


@dataclasses.dataclass
class Run:
    chunks: list                # every chunk submitted, in order
    kept: list                  # the reservoir's chunks, outputs on host
    t0: float
    t_end: float                # submissions stop at t_end (or the count)

    def done_by(self, t: float) -> list:
        return [c for c in self.chunks if c.t_done <= t]


INFLIGHT = 2     # chunks submitted and not yet read back
KEEP = 2         # chunks the reservoir keeps for the comparison


class Loop:
    """Owns the pinned buffers and the copy stream of one process."""

    def __init__(self, program):
        self.program = program
        self.stream = torch.cuda.Stream() if torch.cuda.is_available() \
            and program.inputs.ring[0][0].is_cuda else None
        self.free: queue.Queue = queue.Queue()
        self.slots = threading.Semaphore(INFLIGHT)
        self.allocated = False

    def _buffers_like(self, out: dict) -> dict:
        pin = self.stream is not None
        return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                for k, v in out.items()}

    def _copy(self, chunk: Chunk, buf: dict) -> None:
        if self.stream is None:
            for k, v in chunk.out.items():
                buf[k].copy_(v)
            return
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            for k, v in chunk.out.items():
                buf[k].copy_(v, non_blocking=True)
            chunk.event = torch.cuda.Event(enable_timing=True)
            chunk.event.record(self.stream)

    def run(self, first: int, *, seconds: float | None = None,
            count: int | None = None, rng=None) -> Run:
        """Chunks first, first + 1, ... until ``seconds`` have passed since
        the first submission, or ``count`` chunks; then waits for every
        one.  With ``rng`` the reservoir keeps KEEP chunks."""
        todo: queue.Queue = queue.Queue()
        chunks, kept = [], []
        state = {"seen": 0, "error": None}

        def reader():
            while True:
                item = todo.get()
                if item is None:
                    return
                chunk, buf = item
                try:
                    if chunk.event is not None:
                        chunk.event.synchronize()
                    chunk.t_done = time.perf_counter()
                    chunk.out = None
                    types = buf["types"].numpy()
                    chunk.counts = np.stack([(types == k).sum(-1)
                                             for k in (1, 2, 3)], -1)
                except Exception as e:        # surfaced by the main thread
                    state["error"] = e
                    self.free.put(buf)
                    continue
                finally:
                    self.slots.release()
                j = state["seen"]
                state["seen"] += 1
                if rng is None:
                    self.free.put(buf)
                elif len(kept) < KEEP:
                    chunk.host = buf
                    kept.append(chunk)
                else:
                    r = int(rng.integers(0, j + 1))
                    if r < KEEP:
                        self.free.put(kept[r].host)
                        kept[r].host = None
                        chunk.host = buf
                        kept[r] = chunk
                    else:
                        self.free.put(buf)

        thread = threading.Thread(target=reader, daemon=True)
        thread.start()
        origin = None
        if self.stream is not None:
            torch.cuda.synchronize()
            origin = torch.cuda.Event(enable_timing=True)
            origin.record()
            origin.synchronize()
        t0 = time.perf_counter()
        i = first
        try:
            while True:
                now = time.perf_counter()
                if (seconds is not None and now - t0 >= seconds) or (
                        count is not None and i - first >= count):
                    break
                if state["error"] is not None:
                    raise state["error"]
                self.slots.acquire()
                chunk = Chunk(index=i, t_submit=time.perf_counter())
                with record_function("portbench.submit"):
                    chunk.out = self.program.submit(i)
                chunk.t_return = time.perf_counter()
                with record_function("portbench.read_back"):
                    buf = self._take(chunk.out)
                    self._copy(chunk, buf)
                chunks.append(chunk)
                todo.put((chunk, buf))
                i += 1
        finally:
            todo.put(None)
            thread.join(timeout=120.0)
        if thread.is_alive():
            raise RuntimeError("the read-back did not finish within 120 s")
        if state["error"] is not None:
            raise state["error"]
        if origin is not None:
            for c in chunks:
                c.t_done = t0 + origin.elapsed_time(c.event) * 1e-3
                c.event = None
        t_end = t0 + seconds if seconds is not None else \
            max(c.t_done for c in chunks)
        return Run(chunks, kept, t0, t_end)

    def _take(self, out: dict) -> dict:
        """A free set of buffers: the in-flight chunks' and the
        reservoir's, all made at the first chunk."""
        if not self.allocated:
            for _ in range(INFLIGHT + KEEP):
                self.free.put(self._buffers_like(out))
            self.allocated = True
        return self.free.get()

    def release(self, run: Run) -> None:
        """Gives the reservoir's buffers back."""
        for chunk in run.kept:
            self.free.put(chunk.host)
            chunk.host = None
