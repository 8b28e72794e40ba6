"""Elastic scaling of the serving plane (port of
``repro.serving.elastic``: ``ElasticPool``, the same numpy code).

``ElasticPool`` tracks healthy device groups; the runtime fails a group
on eviction and recovers it on re-admission.  The reference's ``remesh``
and ``reshard_params`` rebuild a device mesh and belong to the stream
sharding slice.

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
