"""detector_ms: device time a traced chunk of the kernels under the
profiler's aten::convolution (the detector's convolutions)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.conv_us <= 0:
        return None
    return t.conv_us / len(t.run.chunks) / 1e3
