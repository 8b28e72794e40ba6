"""Ambient shard context (port of ``repro.distributed.context``).

Code consults it to decide whether to run sharded: launchers run inside
``with shard_ctx(mesh, rules): ...``; CPU tests run with no context and
take the purely local paths.
"""
from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import AxisRules


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Mesh
    rules: AxisRules

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return self.rules.mesh_axes("batch")

    @property
    def tensor_axes(self) -> tuple[str, ...]:
        return self.rules.mesh_axes("tensor")

    @property
    def stream_axes(self) -> tuple[str, ...]:
        """Mesh axes the serving stream dim shards over (axes named by the
        rule table but absent from this mesh are dropped)."""
        from repro_torch.distributed.stream_sharding import stream_axis_names
        return stream_axis_names(self.mesh, self.rules)

    @property
    def stream_shards(self) -> int:
        """Stream-axis data-parallel extent of the ambient mesh."""
        return self.axis_size(self.stream_axes)

    @property
    def runs_shards(self) -> bool:
        """False on a mesh of ``meta`` devices (the dry run's), which lays
        shapes out and runs no shard: code that would split its work over
        the mesh takes its local path there."""
        return self.mesh.devices.flat[0].type != "meta"

    def axis_size(self, axes: tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n


_CTX: list[ShardCtx] = []


@contextlib.contextmanager
def shard_ctx(mesh: Mesh, rules: AxisRules):
    _CTX.append(ShardCtx(mesh, rules))
    try:
        yield _CTX[-1]
    finally:
        _CTX.pop()


def current_ctx() -> ShardCtx | None:
    return _CTX[-1] if _CTX else None
