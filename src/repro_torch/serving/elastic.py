"""Elastic scaling of the serving plane (port of
``repro.serving.elastic``: ``ElasticPool``, the same numpy code, and
``remesh``).

``ElasticPool`` tracks healthy device groups; the runtime fails a group
on eviction and recovers it on re-admission.  ``remesh`` rebuilds a
(data, model) mesh from the healthy groups' devices, and
``reshard_params`` lays parameters out on it by their logical axes.

Contract with the async dispatch plane (``serving/runtime.py``): an
eviction re-homes both the evicted shard's QUEUED requests and its
pending (submitted-but-unflushed) tickets onto survivor shards; batches
already dispatched to the evicted device are NOT cancelled — they retire
normally at the next double-buffer rotation or at ``poll``, so in-flight
results are never dropped mid-eviction.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.mesh import Mesh, device_put
from repro_torch.distributed.sharding import make_axis_rules, tree_shardings


@dataclasses.dataclass
class ElasticPool:
    """Health bitmap over replica groups (e.g. data-axis rows).

    ``healthy`` defaults to all-True; a caller-provided array is coerced
    to a bool copy (so external mutation can't corrupt the pool) and must
    have exactly ``n_groups`` entries.
    """
    n_groups: int
    healthy: np.ndarray | None = None

    def __post_init__(self):
        if self.n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {self.n_groups}")
        if self.healthy is None:
            self.healthy = np.ones(self.n_groups, bool)
        else:
            h = np.asarray(self.healthy)
            if h.shape != (self.n_groups,):
                raise ValueError(
                    f"healthy must have shape ({self.n_groups},), "
                    f"got {h.shape}")
            self.healthy = h.astype(bool, copy=True)

    def _check(self, group: int):
        if not 0 <= group < self.n_groups:
            raise IndexError(
                f"group {group} outside pool of {self.n_groups}")

    def fail(self, group: int):
        self._check(group)
        self.healthy[group] = False

    def recover(self, group: int):
        self._check(group)
        self.healthy[group] = True

    @property
    def n_healthy(self) -> int:
        return int(self.healthy.sum())

    def healthy_groups(self) -> list[int]:
        return [int(g) for g in np.nonzero(self.healthy)[0]]

    def usable_power_of_two(self) -> int:
        """Largest power-of-two group count <= healthy (mesh axes like
        powers of two; spares idle until enough recover).  0 when no
        group is healthy."""
        n = self.n_healthy
        if n == 0:
            return 0
        p = 1
        while p * 2 <= n:
            p *= 2
        return p


def remesh(pool: ElasticPool, n_model: int = 1, *, devices=None) -> Mesh:
    """Build the largest viable (data, model) mesh from healthy groups.

    ``devices`` (by default every CUDA device of the machine; raises
    without CUDA) are the pool's devices in group order.  When they split
    evenly across the pool's groups, the mesh is built from the surviving
    groups' devices specifically (an evicted group's device really leaves
    the mesh); otherwise the groups are logical and the mesh just shrinks
    its data axis.  A device may repeat (a logical mesh).

    Raises ``RuntimeError`` instead of producing a 0-sized mesh when too
    few healthy groups remain to place even one model replica.
    """
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("remesh: CUDA is not available; pass "
                               "devices= to name the pool's devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    usable = pool.usable_power_of_two()
    if usable == 0:
        raise RuntimeError(
            f"cannot remesh: 0 of {pool.n_groups} groups healthy")
    if len(devices) % pool.n_groups == 0 and pool.n_healthy < pool.n_groups:
        per = len(devices) // pool.n_groups
        sel = [d for g in pool.healthy_groups()
               for d in devices[g * per:(g + 1) * per]]
    else:
        sel = devices
    n_data = min(usable, len(sel) // n_model)
    if n_data < 1:
        raise RuntimeError(
            f"cannot remesh: {len(sel)} usable device(s) across "
            f"{pool.n_healthy}/{pool.n_groups} healthy groups cannot "
            f"host n_model={n_model}")
    grid = np.empty(n_data * n_model, dtype=object)
    grid[:] = sel[:n_data * n_model]
    return Mesh(grid.reshape(n_data, n_model), ("data", "model"))


def reshard_params(params, specs_tree, mesh: Mesh, multi_pod: bool = False):
    """``params`` (a nested dict of tensors) laid out on ``mesh`` by their
    specs' logical axes under the baseline rules (post-failure
    continuation): the same nesting of ``mesh.Placed``."""
    shardings = tree_shardings(mesh, specs_tree, make_axis_rules(multi_pod))

    def put(p, sh):
        if isinstance(p, dict):
            return {k: put(v, sh[k]) for k, v in p.items()}
        return device_put(p, sh)
    return put(params, shardings)
