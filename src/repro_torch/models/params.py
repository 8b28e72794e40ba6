"""Single-source parameter declaration (port of ``repro.models.params``).

Each model declares its parameters once, as a nested dict of
:class:`ParamSpec` (shape + logical axes + initialiser); ``init_params``
makes real tensors from it, ``abstract_params`` storage-free
``ShapeDtypeStruct``s with their placement for the dry run
(:mod:`repro_torch.launch.dryrun`).  ``axes`` are kept as the reference
declares them: the logical axis of each dimension, which
``distributed.sharding.named_sharding`` maps onto a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

# values drawn per call on the device: 64 Mi f32 values (256 MiB), so
# that a 128256 x 2048 embedding needs no whole f32 copy of itself
INIT_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | fan_in
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def spec(shape: Sequence[int], axes: Sequence[str | None], **kw) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), **kw)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _leaves(tree):
    if isinstance(tree, ParamSpec):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def _init_one(generator, s: ParamSpec, device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if s.init == "fan_in":
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[0]
        std = 1.0 / math.sqrt(fan_in)
    elif s.init == "normal":
        std = s.scale
    else:
        raise ValueError(f"unknown init rule {s.init!r}")
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - i)
        z = torch.randn(n, generator=generator, dtype=torch.float32,
                        device=device)
        flat[i:i + n] = (z * std).to(s.dtype)
    return out


def init_params(generator: torch.Generator, specs_tree, device) -> dict:
    """Tensors for every spec of ``specs_tree``, in its nesting, made on
    ``device``: N(0, 1/fan_in) for ``fan_in`` (fan-in = the second-last
    dimension), N(0, scale^2) for ``normal``, f32 draws rounded to the
    spec's dtype, as the reference's rules (``params.py:35-44``).  The
    draws come from ``generator``, which must live on ``device``; they are
    made there in chunks, so the values never pass through the host.
    The reference's ``jax.random`` gives other numbers from the same seed.
    """
    if isinstance(specs_tree, ParamSpec):
        return _init_one(generator, specs_tree, device)
    return {k: init_params(generator, v, device)
            for k, v in specs_tree.items()}


def abstract_params(specs_tree, mesh=None, rules=None):
    """A :class:`repro_torch.distributed.mesh.ShapeDtypeStruct` for every
    spec, in its nesting, placed by ``named_sharding(mesh, spec.axes,
    rules, spec.shape)`` when a mesh is given (a dimension that does not
    divide over its mesh axes replicated, as the reference's)."""
    from repro_torch.distributed.mesh import ShapeDtypeStruct
    from repro_torch.distributed.sharding import named_sharding
    if is_spec(specs_tree):
        sh = None if mesh is None else named_sharding(
            mesh, specs_tree.axes, rules, specs_tree.shape)
        return ShapeDtypeStruct(specs_tree.shape, specs_tree.dtype, sh)
    return {k: abstract_params(v, mesh, rules)
            for k, v in specs_tree.items()}


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys sorted at every level (the order
    in which ``jax.tree.leaves`` lists a dict's leaves)."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over nested dicts of one structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}


def tree_unstack(tree) -> list:
    """A nested dict of leaves stacked on dim 0 -> a list of nested dicts,
    one an index of that dim (the reference scans such stacks).  One
    ``unbind`` a leaf, so that autograd stacks the gradients of a leaf's
    slices once."""
    if not isinstance(tree, dict):
        return list(tree.unbind(0))
    parts = {k: tree_unstack(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def tree_stack(trees: list):
    """The inverse of :func:`tree_unstack`."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def param_count(specs_tree) -> int:
    return sum(math.prod(s.shape) for s in _leaves(specs_tree))


def param_bytes(specs_tree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in _leaves(specs_tree))
