"""Production mesh builders (port of ``repro.launch.mesh``) and the card's
constants for a roofline.

Functions, not module-level meshes, so that importing this module
touches no device.  A mesh names ``torch.device``s
(:mod:`repro_torch.distributed.mesh`): by default the machine's CUDA
cards, or the caller's ``devices=``.  The dry run
(:mod:`repro_torch.launch.dryrun`) passes ``[torch.device("meta")] * n``,
a logical mesh that holds shapes and allocates nothing.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import make_mesh


def production_shape(*, multi_pod: bool = False,
                     degraded: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of a production mesh: (16, 16) ("data",
    "model"); (2, 16, 16) ("pod", "data", "model") across two pods; the
    degraded (8, 16) ("data", "model")."""
    if degraded:
        return (8, 16), ("data", "model")
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, degraded: bool = False,
                         devices=None):
    """degraded=True builds the (8, 16) elastic-continuation mesh: the
    shape the fleet re-forms after losing a data-axis slice (half the
    pod's rows); checkpoints restore onto it via train/checkpoint.py.
    ``devices``: as :func:`repro_torch.distributed.mesh.make_mesh` (None:
    that many CUDA cards, or it raises)."""
    shape, axes = production_shape(multi_pod=multi_pod, degraded=degraded)
    return make_mesh(shape, axes, devices=devices)


# NVIDIA H100 SXM (H100 80GB HBM3), published dense peaks at its 700 W
# power limit (NVIDIA's data sheet); a card set to a lower limit runs
# slower under load
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores, dense
HBM_BW = 3.35e12              # B/s
