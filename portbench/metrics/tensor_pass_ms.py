"""tensor_pass_ms: device time a traced chunk of PyTorch's own element-wise,
reduction, indexing and copy kernels (namespace at::native)."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = t.time_us("at::native::")
    return us / len(t.run.chunks) / 1e3 if us > 0 else None
