from repro_torch.kernels.blockdct.ops import blockdct_quantize  # noqa: F401
