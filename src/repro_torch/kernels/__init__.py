"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their wrappers and
their plain PyTorch versions.  ``build`` compiles and binds them; each
``<kernel>/ops.py`` holds a wrapper and its plain version."""
