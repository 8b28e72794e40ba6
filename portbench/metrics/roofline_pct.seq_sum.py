"""roofline_pct.seq_sum: the seq_sum task's bound over the traced chunks
(counts.py: operations at 67 TFLOP/s or bytes at 3.35 TB/s, whichever is
longer), as a share of the device time of its kernels: seq_sum_kernel."""
from harness.readers import roofline_pct

KERNELS = ("seq_sum_kernel",)


def read(ctx):
    return roofline_pct(ctx, "seq_sum", *KERNELS)
