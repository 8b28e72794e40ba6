"""roofline_pct.roi_gather: the roi_gather task's bound over the traced chunks
(counts.py: operations at 67 TFLOP/s or bytes at 3.35 TB/s, whichever is
longer), as a share of the device time of its kernels: roi_gather_kernel."""
from harness.readers import roofline_pct

KERNELS = ("roi_gather_kernel",)


def read(ctx):
    return roofline_pct(ctx, "roi_gather", *KERNELS)
