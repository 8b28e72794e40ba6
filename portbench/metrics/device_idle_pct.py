"""device_idle_pct: the share of the traced window in which no operation
ran on the device (the profiler's intervals of every kernel, copy and
fill, merged)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
