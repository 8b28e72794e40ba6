"""host_enqueue_ms: the median over the measured window's chunks of the
host's time from the call of the round-trip entry to its return, before
the read-back."""
import statistics


def read(ctx):
    spans = [(c.t_return - c.t_submit) * 1e3 for c in ctx.window.chunks]
    return statistics.median(spans) if spans else None
