"""``shard_map`` for one process that owns every device of a mesh (the
port's counterpart of ``repro.distributed.shard_map_compat``, which wraps
``jax.shard_map``).

``shard_map_compat(body, mesh, in_specs, out_specs, reduce=None)``
returns a function of the same positional operands as ``body``.  A spec
has one entry a dimension (missing trailing entries replicate): None, a
mesh axis name, or a tuple of them, the dimension split into as many
equal slices as those axes' sizes multiply to, slice i going to the
devices whose coordinates on those axes, row-major in the entry's order,
are i.  ``P()`` replicates the operand.

The body runs once a shard: once for each combination of coordinates on
the mesh axes that the in_specs name (in mesh order, every other axis at
index 0), on the device there, each shard under its device
(``torch.cuda.device``), one after another on the host: CUDA launches
return before the device runs them, so shards on distinct cards overlap.
Operands split along dimension 0 (streams, a batch) are sliced and copied
to the shards' devices at every call.  The others (``P()`` and splits of
later dimensions: parameters) are copied to a device the first time a
shard there needs their slice, and the copy is kept with the tensor (on
its base, where it is a view, such as one layer of a stacked weight)
until the tensor changes in place: later calls, and other functions
built by ``shard_map_compat``, take the kept copy.  A slice already on
its shard's device is a view, never copied; a tensor that requires grad
under autograd is copied at every call, so its gradient flows.

``out_specs`` is one spec for the whole output, or a tuple of specs, one
for each element of a tuple output.  Each output's shards are gathered on
the mesh's first device: ``reduce`` (None, or one entry an output, each
None or ``("sum" | "mean", axes)``) first combines them over the named
mesh axes, in row-major order of those axes, in the output's dtype (the
reference body's ``psum`` and ``pmean``, taken here as reductions of the
shards' outputs, since the shards do not run at once); then a split entry
concatenates the slices along its dimension, and an axis the spec does
not name takes its index-0 shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math

import numpy as np
import torch

from repro_torch.distributed.sharding import P


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


def _entries(mesh, spec, ndim=None) -> list[tuple[str, ...] | None]:
    """The spec's entries as tuples of mesh axes (None: not split), one a
    dimension, padded with None to ``ndim``."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if not all(isinstance(a, str) for a in axes):
            raise ValueError(f"spec {spec}: an entry is None, a mesh axis "
                             f"name or a tuple of them")
        missing = [a for a in axes if a not in mesh.shape]
        if missing:
            raise ValueError(f"spec {spec} names axes {missing} not in the "
                             f"mesh's {tuple(mesh.shape)}")
        out.append(axes)
    if ndim is not None:
        if len(out) > ndim:
            raise ValueError(f"spec {spec} has {len(out)} entries for a "
                             f"tensor of rank {ndim}")
        out += [None] * (ndim - len(out))
    return out


def _named_axes(mesh, spec) -> set[str]:
    return {a for e in _entries(mesh, spec) if e for a in e}


def _block(mesh, axes, coords) -> int:
    """Row-major index of ``coords`` over ``axes`` (in the axes' order)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords.get(a, 0)
    return i


def _piece(mesh, x, entries, coords):
    """The slice of ``x`` at ``coords`` under the spec's ``entries``."""
    for dim, axes in enumerate(entries):
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not split {n} ways")
        k = x.shape[dim] // n
        i = _block(mesh, axes, coords)
        x = x.narrow(dim, i * k, k)
    return x


def _to(x, dev):
    return x.to(dev, non_blocking=dev.type == "cuda")


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _slice_to(mesh, x, spec, coords, dev):
    """The slice at ``coords`` of ``x`` (a tensor or host data) under
    ``spec``, on ``dev``."""
    x = torch.as_tensor(x)
    return _to(_piece(mesh, x, _entries(mesh, spec, x.dim()), coords), dev)


def _same_device(t, dev) -> bool:
    """Whether ``t`` is on ``dev`` as the mesh names it: a CPU device with
    an index is a logical device of its own, apart from the CPU's."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return t.device == dev


def _param_slice(mesh, x, spec, coords, dev):
    """The slice at ``coords`` of parameter ``x`` under ``spec``, on
    ``dev``: a view where it is there already, else a copy kept on ``x``'s
    base, keyed by the device and the slice's place in the base's storage,
    and made again when the base's version counter moves."""
    piece = _piece(mesh, x, _entries(mesh, spec, x.dim()), coords)
    if _same_device(piece, dev):
        return piece
    if torch.is_grad_enabled() and x.requires_grad:
        return _to(piece, dev)
    base = x if x._base is None else x._base
    kept = base.__dict__.setdefault("_mesh_copies", {})
    key = (str(dev), piece.storage_offset(), tuple(piece.shape),
           piece.stride())
    if key not in kept or kept[key][0] != base._version:
        kept[key] = (base._version, _to(piece, dev))
    return kept[key][1]


def _reduce(op, xs):
    """``xs`` (on one device) summed one at a time in order, in their
    dtype; "mean" then divides by their number."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc / len(xs) if op == "mean" else acc


def _gather(mesh, used, outs, spec, reduce, home):
    """One output of every shard (``outs``: coords tuple over ``used`` ->
    leaf) gathered on ``home`` under ``spec`` and ``reduce``."""
    red = () if reduce is None else (
        reduce[1] if isinstance(reduce[1], tuple) else (reduce[1],))

    def at(coords):
        """The (reduced) leaf at ``coords`` (a dict axis -> index)."""
        def leaf(c):
            return outs[tuple(c.get(a, 0) for a in used)]
        if not red:
            return leaf(coords)
        grid = [range(mesh.shape[a]) for a in red]
        xs = [leaf({**coords, **dict(zip(red, idx))})
              for idx in itertools.product(*grid)]
        if not torch.is_tensor(xs[0]):
            return xs[0]
        return _reduce(reduce[0], [_to(x, home) for x in xs])

    sample = next(iter(outs.values()))
    if not torch.is_tensor(sample):
        return at({})
    entries = _entries(mesh, spec, sample.dim())
    split = [(d, axes) for d, axes in enumerate(entries) if axes]

    def build(k, coords):
        """Concatenate along the k-th split dimension and after."""
        if k == len(split):
            return _to(at(coords), home)
        dim, axes = split[k]
        parts = []
        for i in range(math.prod(mesh.shape[a] for a in axes)):
            idx = np.unravel_index(i, [mesh.shape[a] for a in axes])
            parts.append(build(k + 1, {**coords, **dict(
                zip(axes, (int(j) for j in idx)))}))
        return torch.cat(parts, dim) if len(parts) > 1 else parts[0]

    return build(0, {})


def shard_map_compat(body, mesh, in_specs, out_specs, reduce=None):
    """``body`` run on each shard of ``mesh`` (see the module's doc)."""
    named = set()
    for spec in in_specs:
        named |= _named_axes(mesh, spec)
    per_output = not isinstance(out_specs, P)
    out_list = list(out_specs) if per_output else [out_specs]
    reduce_list = list(reduce) if reduce is not None \
        else [None] * len(out_list)
    if len(reduce_list) != len(out_list):
        raise ValueError(f"{len(reduce_list)} reduce entries for "
                         f"{len(out_list)} out_specs")
    for spec, red in zip(out_list, reduce_list):
        axes = _named_axes(mesh, spec)
        if red is not None:
            if red[0] not in ("sum", "mean"):
                raise ValueError(f"reduce {red}: the op is 'sum' or 'mean'")
            r = red[1] if isinstance(red[1], tuple) else (red[1],)
            _entries(mesh, P(r))
            axes |= set(r)
        if not axes <= named:
            raise NotImplementedError(
                f"outputs split or reduced over {sorted(axes - named)}, "
                f"which no operand is split over")
    used = tuple(a for a in mesh.axis_names if a in named)
    shards = [dict(zip(used, (int(j) for j in idx))) for idx in
              itertools.product(*(range(mesh.shape[a]) for a in used))]
    home = mesh.devices.flat[0]
    streamed = [bool(s) and bool(_entries(mesh, s)[0]) for s in in_specs]

    def device(coords):
        return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} operands for {len(in_specs)} "
                            f"in_specs")
        outs = {}
        for coords in shards:
            dev = device(coords)
            shard_args = [
                tree_map(lambda x, s=spec: _slice_to(mesh, x, s, coords, dev),
                         arg) if st
                else tree_map(lambda x, s=spec: _param_slice(
                    mesh, x, s, coords, dev) if torch.is_tensor(x) else x, arg)
                for st, spec, arg in zip(streamed, in_specs, args)]
            with _on(dev):
                outs[tuple(coords[a] for a in used)] = body(*shard_args)
        results = []
        for j, (spec, red) in enumerate(zip(out_list, reduce_list)):
            mine = [o[j] if per_output else o for o in outs.values()]
            gathered = iter([
                _gather(mesh, used, dict(zip(outs, col)), spec, red, home)
                for col in zip(*(tree_leaves(o) for o in mine))])
            results.append(tree_map(lambda _: next(gathered), mine[0]))
        return tuple(results) if per_output else results[0]

    return run
