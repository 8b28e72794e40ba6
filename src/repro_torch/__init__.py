"""PyTorch/CUDA port of the BiSwift reproduction.

Laid out like ``repro`` (``codec/``, ``core/``, ``kernels/``, ``models/``,
``sim/``): each module sits at the path of the JAX module it reproduces and
is held against it by ``tests/test_torch_*.py``.  The port imports
``torch`` and ``numpy`` only.  Entry points run on CUDA unless the caller
passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
