"""roofline_pct.qtransfer: the qtransfer task's bound over the traced chunks
(counts.py: operations at 67 TFLOP/s or bytes at 3.35 TB/s, whichever is
longer), as a share of the device time of its kernels: qtransfer_kernel."""
from harness.readers import roofline_pct

KERNELS = ("qtransfer_kernel",)


def read(ctx):
    return roofline_pct(ctx, "qtransfer", *KERNELS)
