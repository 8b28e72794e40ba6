"""A traced stretch of chunks under ``torch.profiler`` and what the
per-layer readers take from it: every device operation's interval and
name, the device time under the detector's convolutions, the idle gaps
labelled by what the host was doing."""
from __future__ import annotations

import bisect
import collections
import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW_SPAN = "portbench.traced_window"


@dataclasses.dataclass
class Trace:
    ops: list              # (name, start_us, end_us) of every device op
    conv_us: float         # device time under aten::convolution
    window_us: float
    busy_us: float
    run: object            # the loop's Run of the traced chunks
    breakdown: dict

    def time_us(self, *needles) -> float:
        """Device time of the ops whose name holds any of ``needles``."""
        return sum(e - s for n, s, e in self.ops
                   if any(k in n for k in needles))


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _under(evt, name: str) -> bool:
    p = evt.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def profile_chunks(loop, first: int, count: int) -> Trace:
    """``count`` chunks from ``first`` under the profiler, after the
    device has drained, so that the traced window holds their work
    alone."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU]
    if loop.stream is not None:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            run = loop.run(first, count=count)
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW_SPAN).time_range
    w0, w1 = window.start, window.end
    device, cpu = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith("portbench."):
                continue              # the harness's spans, drawn on the GPU
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                device.append((e.name, s, t))
        elif e.name != WINDOW_SPAN:
            cpu.append(e)
    conv_us = sum(e.device_time_total for e in cpu
                  if e.name == "aten::convolution"
                  and not _under(e, "aten::convolution"))
    busy = _merged([(s, t) for _, s, t in device])
    busy_us = sum(t - s for s, t in busy)
    return Trace(ops=device, conv_us=conv_us, window_us=w1 - w0,
                 busy_us=busy_us, run=run,
                 breakdown=_breakdown(device, busy, cpu, w0, w1))


def _breakdown(device, busy, cpu, w0, w1) -> dict:
    """The ten device ops that took most time, and the ten host
    activities under which the device stood idle longest."""
    by_op = collections.Counter()
    for name, s, t in device:
        by_op[name[:120]] += (t - s) * 1e-6
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if w1 > at:
        gaps.append((at, w1))
    spans = [e for e in cpu if e.name.startswith("portbench.")]
    cpu = sorted((e for e in cpu if not e.name.startswith("portbench.")),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in cpu]
    by_host = collections.Counter()
    for s, t in gaps:
        mid = (s + t) / 2
        label = next((f"{e.name}: Python between operators" for e in spans
                      if e.time_range.start <= mid <= e.time_range.end),
                     "the harness's loop")
        j0 = bisect.bisect_right(starts, mid) - 1
        for j in range(j0, max(-1, j0 - 400), -1):
            if cpu[j].time_range.end >= mid:
                label = cpu[j].name[:120]
                break
        by_host[label] += (t - s) * 1e-6
    return {"device_ops": [[n, v] for n, v in by_op.most_common(10)],
            "idle_gaps": [[n, v] for n, v in by_host.most_common(10)]}
