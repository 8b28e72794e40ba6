"""What the per-layer metric files share: the context a reader gets, and
the roofline share of a kernel."""
from __future__ import annotations

import dataclasses

from harness import counts


@dataclasses.dataclass
class Context:
    cfg: dict
    shape: tuple           # (S, T, H, W)
    scales: object         # chunk index -> each stream's LR scale
    window: object         # the measured window's Run
    seconds: float
    trace: object = None   # the traced chunks' Trace, with --trace 1

    def work(self, chunk) -> counts.Work:
        S, T, H, W = self.shape
        return counts.chunk_work(self.cfg, self.scales(chunk.index),
                                 chunk.counts, H, W, T)


def roofline_pct(ctx: Context, kernel: str, *names):
    """The kernel's bound (operations at 67 TFLOP/s or bytes at 3.35 TB/s,
    whichever is longer) over the traced chunks, as a share of its device
    time there; None where the trace holds none of its launches."""
    if ctx.trace is None:
        return None
    spent = ctx.trace.time_us(*names) * 1e-6
    bound = sum(ctx.work(c).bound_s(kernel) for c in ctx.trace.run.chunks)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
