"""``shard_map`` for one process that owns every device of a mesh (the
port's counterpart of ``repro.distributed.shard_map_compat``, which wraps
``jax.shard_map``).

``shard_map_compat(body, mesh, in_specs, out_specs)`` returns a function
of the same positional operands as ``body``.  It takes the specs stream
sharding uses:

* ``P(axes)`` (one entry, a mesh axis name or a tuple of them) splits
  dimension 0 of every tensor of the operand into as many equal slices as
  the axes' sizes multiply to, slice i to the i-th device of those axes in
  the mesh's row-major order (index 0 on every other axis);
* ``P()`` replicates: one copy of the operand a distinct device of the
  mesh, made the first time the function sees it and kept while the
  caller passes the same, unchanged, tensors (the detector's params);
* ``out_specs`` is one spec for the whole output: ``P(axes)``
  concatenates the shards' outputs along dimension 0 on the mesh's first
  device, ``P()`` returns shard 0's output there.

Any other spec (a split of another dimension, two split dimensions) places
parameters across devices, which only the MoE and training slices need;
it raises ``NotImplementedError``.

Each shard's body runs under its device (``torch.cuda.device``), one shard
after another on the host: CUDA launches return before the device runs
them, so shards on distinct cards overlap.  There is no collective; the
bodies of stream sharding need none.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``): dicts, lists, tuples and dataclass instances are nodes,
    anything else a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _split_axes(mesh, spec) -> tuple[str, ...] | None:
    """The mesh axes a spec splits dimension 0 over; None for P()."""
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    if not parts:
        return None
    entry = parts[0]
    axes = entry if isinstance(entry, tuple) else (entry,)
    if len(parts) > 1 or entry is None \
            or not all(isinstance(a, str) for a in axes):
        raise NotImplementedError(
            f"spec {spec}: only P() and a split of dimension 0 are ported "
            f"(stream sharding); placing parameters across devices comes "
            f"with the MoE slice")
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"spec {spec} names axes {missing} not in the "
                         f"mesh's {tuple(mesh.shape)}")
    return axes


def _shard_devices(mesh, axes) -> list[torch.device]:
    """Device of each slice of a split over ``axes``: row-major over the
    axes' sizes, index 0 on every other mesh axis."""
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for i in range(int(np.prod(sizes))):
        pos = dict(zip(axes, np.unravel_index(i, sizes)))
        out.append(mesh.devices[tuple(int(pos.get(a, 0))
                                      for a in mesh.axis_names)])
    return out


def _to(x, dev):
    return x.to(dev, non_blocking=dev.type == "cuda")


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


class _Replicated:
    """One replicated operand's copies, one a device, kept while the
    caller passes the same tensors unchanged (the same objects at the
    same version counters)."""

    def __init__(self):
        self._src = None
        self._copies = {}

    def on(self, tree, dev):
        src = [(x, x._version) for x in tree_leaves(tree)
               if torch.is_tensor(x)]
        if self._src is None or len(src) != len(self._src) or any(
                a is not b or va != vb
                for (a, va), (b, vb) in zip(src, self._src)):
            self._src, self._copies = src, {}
        if dev not in self._copies:
            self._copies[dev] = tree_map(
                lambda x: _to(x, dev) if torch.is_tensor(x) else x, tree)
        return self._copies[dev]


def shard_map_compat(body, mesh, in_specs, out_specs):
    """``body`` run on each shard of ``mesh`` (see the module's doc)."""
    in_axes = [_split_axes(mesh, s) for s in in_specs]
    split = {a for a in in_axes if a is not None}
    if len(split) > 1:
        raise NotImplementedError(
            f"operands split over different axes {sorted(split)}")
    out_axes = _split_axes(mesh, out_specs)
    if out_axes is not None and split and out_axes not in split:
        raise NotImplementedError(f"outputs split over {out_axes}, operands "
                                  f"over {split.pop()}")
    axes = next(iter(split), out_axes)
    devs = _shard_devices(mesh, axes) if axes else [mesh.devices.flat[0]]
    home = mesh.devices.flat[0]
    replicated = [_Replicated() if a is None else None for a in in_axes]

    def piece(x, i: int, n: int):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"dimension 0 of size {x.shape[0]} does not "
                             f"split {n} ways")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} operands for {len(in_specs)} "
                            f"in_specs")
        n = len(devs)
        outs = []
        for i, dev in enumerate(devs):
            shard_args = [
                rep.on(arg, dev) if rep is not None
                else tree_map(lambda x: _to(piece(x, i, n), dev), arg)
                for rep, arg in zip(replicated, args)]
            with _on(dev):
                outs.append(body(*shard_args))
        if out_axes is None:
            return tree_map(lambda x: _to(x, home) if torch.is_tensor(x)
                            else x, outs[0])
        return tree_map(lambda *xs: torch.cat([_to(x, home) for x in xs])
                        if len(xs) > 1 else _to(xs[0], home), *outs)

    return run

