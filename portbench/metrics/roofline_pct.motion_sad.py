"""roofline_pct.motion_sad: the motion_sad task's bound over the traced chunks
(counts.py: operations at 67 TFLOP/s or bytes at 3.35 TB/s, whichever is
longer), as a share of the device time of its kernels:
motion_sad_exhaustive_kernel, motion_sad_diamond_kernel."""
from harness.readers import roofline_pct

KERNELS = ("motion_sad_exhaustive_kernel", "motion_sad_diamond_kernel")


def read(ctx):
    return roofline_pct(ctx, "motion_sad", *KERNELS)
