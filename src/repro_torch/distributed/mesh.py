"""A mesh of devices in one process: the port's stand-in for
``jax.sharding.Mesh``, ``NamedSharding``, ``jax.make_mesh``,
``jax.device_put`` onto a sharding and ``jax.ShapeDtypeStruct``.

One process owns every device of the mesh, as under JAX's single
controller: stream-sharded work copies each shard's slice of the stream
axis to its device and runs the body there
(:mod:`repro_torch.distributed.shard_map_compat`).  A mesh may name the
same device more than once (a logical mesh): the CPU tests run 2 and 4
shards that way, and a one-card machine 3 and 4.  The mesh holds exactly
the devices its caller lists; only :func:`make_mesh` picks devices, and it
takes the machine's CUDA devices or raises.

:func:`device_put` lays a tensor out by a :class:`NamedSharding`: a
:class:`Placed` holds, for every device position of the mesh, the slice
of the tensor that the spec gives that position, on that device (a
replicated dimension whole).  ``Placed.full()`` puts the slices back
together: the same values as the tensor placed.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import P


def _device(d) -> torch.device:
    """``d`` as a torch.device, a CUDA device without an index pinned to
    the current one (so that equal devices compare equal)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """``devices``: an array-like of devices (``torch.device`` or a name)
    whose dimensions are the mesh axes ``axis_names``, in order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [_device(d) for d in grid.flat]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device grid")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.devices.flat]})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec`` over ``mesh``'s axes.  Raises ``ValueError``,
    as ``jax.sharding.NamedSharding`` does, where the spec names an axis
    the mesh lacks or one mesh axis for two dimensions."""
    mesh: Mesh
    spec: P

    def __post_init__(self):
        named = [a for entry in self.spec if entry is not None
                 for a in (entry if isinstance(entry, tuple) else (entry,))]
        missing = [a for a in named if a not in self.mesh.shape]
        if missing:
            raise ValueError(f"spec {self.spec} names axes {missing} not in "
                             f"the mesh's {tuple(self.mesh.shape)}")
        if len(set(named)) != len(named):
            raise ValueError(f"spec {self.spec} maps a mesh axis to more "
                             "than one dimension")

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of the slice a mesh position holds: every position
        holds one of that shape (:func:`_slices` raises where a split
        dimension does not divide over its axes)."""
        origin = (0,) * self.mesh.devices.ndim
        return tuple(s.stop - s.start
                     for s in _slices(self, tuple(shape), origin))


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """A tensor's shape, dtype and placement, with no storage: the port's
    stand-in for ``jax.ShapeDtypeStruct`` (the dry run's arguments)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding | None = None

    def shard_shape(self) -> tuple[int, ...]:
        """The slice of the tensor one mesh position holds (the whole
        shape without a sharding)."""
        if self.sharding is None:
            return tuple(self.shape)
        return self.sharding.shard_shape(self.shape)

    @property
    def nbytes(self) -> int:
        """The whole tensor's bytes."""
        return math.prod(self.shape) * self.dtype.itemsize

    def meta(self) -> torch.Tensor:
        """A tensor of this shape and dtype on the ``meta`` device."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (row-major), by default the
    first prod(shape) CUDA devices; raises ``RuntimeError`` when there are
    fewer, and never repeats a device or takes the CPU on its own."""
    shape = tuple(int(n) for n in shape)
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} CUDA devices, found {have}; pass "
                f"devices= to name them (a device may repeat: a logical "
                f"mesh)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), names)


def _slices(sharding: NamedSharding, shape, coords) -> tuple[slice, ...]:
    """The index of the slice at mesh ``coords`` (one index an axis)."""
    mesh = sharding.mesh
    at = dict(zip(mesh.axis_names, coords))
    spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    if len(spec) > len(shape):
        raise ValueError(f"spec {sharding.spec} has {len(spec)} entries "
                         f"for a tensor of rank {len(shape)}")
    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"dimension of size {dim} does not split {n} "
                             f"ways ({sharding.spec})")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + at[a]
        k = dim // n
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


class Placed:
    """A tensor laid out over a mesh: ``shards`` is an object array of the
    mesh's shape, each element the slice of the tensor at that device
    position, on that device (``index`` gives its slices)."""

    def __init__(self, sharding: NamedSharding, shape, dtype, shards):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = shards

    def index(self, coords) -> tuple[slice, ...]:
        return _slices(self.sharding, self.shape, coords)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first by default),
        each element taken from the first mesh position holding it."""
        mesh = self.sharding.mesh
        dev = mesh.devices.flat[0] if device is None else _device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for coords in np.ndindex(*mesh.devices.shape):
            idx = self.index(coords)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:
                done.add(key)
                out[idx] = self.shards[coords].to(dev)
        return out


def device_put(x, sharding: NamedSharding) -> Placed:
    """``x`` (a tensor, or host data) laid out by ``sharding``: each mesh
    position's slice copied to its device (a view where the tensor is
    already there).  Raises ``ValueError`` when a split dimension does
    not divide over its axes."""
    x = torch.as_tensor(x)
    mesh = sharding.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    for coords in np.ndindex(*mesh.devices.shape):
        dev = mesh.devices[coords]
        shards[coords] = x[_slices(sharding, x.shape, coords)].to(
            dev, non_blocking=dev.type == "cuda")
    return Placed(sharding, x.shape, x.dtype, shards)
