from repro_torch.kernels.qtransfer.ops import qtransfer  # noqa: F401
