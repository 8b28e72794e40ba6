"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise.

    ``None`` means CUDA and raises ``RuntimeError`` when CUDA is absent:
    there is no silent fall back to the CPU.  The CPU is used only when
    the caller asks for it (``device="cpu"``, as the parity tests do).

    Also pins full-f32 matmuls and convolutions
    (``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``): the JAX reference
    computes the detector's convolutions in full f32, while cuDNN uses
    TF32 for f32 convolutions by default, which keeps about three decimal
    digits and would break parity.  And pins the sums of bf16 matmuls to
    f32 (``allow_bf16_reduced_precision_reduction = False``): the JAX
    reference accumulates its bf16 LM matmuls in f32, while cuBLAS may
    otherwise reduce split-K partial sums in bf16.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def host_to_device(x, device, dtype=None) -> torch.Tensor:
    """Host data (numpy, a Python sequence or a CPU tensor) as a tensor on
    ``device``, the copy queued without waiting for the device: a
    blocking host-to-device copy first waits for every operation queued
    before it, which would serialise the host's control with the device's
    work.  A tensor already on ``device`` is returned as it is."""
    return torch.as_tensor(x, dtype=dtype).to(device, non_blocking=True)
