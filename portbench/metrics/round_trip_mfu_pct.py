"""round_trip_mfu_pct: the useful operations of the chunks completed in
the measured window (counts.py: the detector on pipelines 1 and 2, the
search's abs-diff-adds, the DCT's multiply-adds), over the window, as a
share of one H100's 67 TFLOP/s in float32."""
from harness.counts import F32_FLOPS


def read(ctx):
    done = ctx.window.done_by(ctx.window.t_end)
    if not done:
        return None
    ops = sum(ctx.work(c).step_ops for c in done)
    return 100.0 * ops / ctx.seconds / F32_FLOPS
