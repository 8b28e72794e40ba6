"""Logical-axis sharding rules (port of ``repro.distributed.sharding``:
the rule tables and the spec helpers, the same pure-Python code).

Every parameter / activation in the model zoo is annotated with *logical*
axis names ("batch", "fsdp", "model_q_heads", ...).  A rule table maps each
logical name onto zero or more *mesh* axes.  This keeps the model code
mesh-agnostic: single-pod (data, model) and multi-pod (pod, data, model)
meshes only differ in their rule tables.

Logical axes used across the zoo
--------------------------------
batch     activation batch dim                -> (pod, data)
fsdp      weight storage shard (ZeRO-3 style) -> (data,)
tensor    tensor-parallel weight dim          -> (model,)
seq_kv    decode KV-cache sequence dim        -> (model,)   (flash-decoding)
expert    MoE expert dim (EP hillclimb)       -> ()  baseline / ("model",) EP
stream    serving stream dim (one video feed) -> (data,)  /  (pod, data)
None      replicated

The "stream" axis is the serving-side analogue of "batch": the batched
chunk forms carry one independent video stream per leading-axis element,
so data-parallel placement over the mesh is exact (no cross-stream
collectives exist in the chunk computation);
:mod:`repro_torch.distributed.stream_sharding` consumes these rules.

``named_sharding`` and ``tree_shardings`` turn a parameter's logical axes
into a :class:`repro_torch.distributed.mesh.NamedSharding` (dimensions
that do not divide over their mesh axes replicated), which
``mesh.device_put`` lays out across the mesh's devices
(``serving/elastic.reshard_params``, ``train/checkpoint.restore``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


class P(tuple):
    """A partition spec: one entry a dimension, each None (replicated), a
    mesh axis name, or a tuple of mesh axis names (the dimension split over
    their product).  ``P()`` replicates everything.  The port's stand-in
    for ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Maps logical axis name -> tuple of mesh axis names."""

    table: Mapping[str, tuple[str, ...]]

    def mesh_axes(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.table.get(logical, ()))


SINGLE_POD_RULES = AxisRules(
    {
        "batch": ("data",),
        "fsdp": ("data",),
        "tensor": ("model",),
        "seq_kv": ("model",),
        "expert": (),
        "stream": ("data",),
    }
)

MULTI_POD_RULES = AxisRules(
    {
        "batch": ("pod", "data"),
        "fsdp": ("data",),
        "tensor": ("model",),
        "seq_kv": ("model",),
        "expert": (),
        "stream": ("pod", "data"),
    }
)

# Hillclimb variants ---------------------------------------------------------
# Expert-parallel MoE: expert dim over model axis (requires E % model == 0).
SINGLE_POD_RULES_EP = AxisRules(
    {**SINGLE_POD_RULES.table, "expert": ("model",), "tensor": ()}
)
MULTI_POD_RULES_EP = AxisRules(
    {**MULTI_POD_RULES.table, "expert": ("model",), "tensor": ()}
)
# FSDP over both pod and data (ZeRO across pods; trades collective locality).
MULTI_POD_RULES_FSDP_POD = AxisRules(
    {**MULTI_POD_RULES.table, "fsdp": ("pod", "data")}
)
# Decode: replicate the KV cache over the tensor axis (q heads stay
# sharded): removes the per-layer softmax reduction over sequence shards at
# the cost of ~tensor x cache replication.
SINGLE_POD_RULES_KVREP = AxisRules(
    {**SINGLE_POD_RULES.table, "seq_kv": ()}
)
MULTI_POD_RULES_KVREP = AxisRules(
    {**MULTI_POD_RULES.table, "seq_kv": ()}
)
# Vision: pure data parallelism: small convnets replicate weights and
# shard batch over every device; TP for 25-100M-param models is overhead.
# Serving streams ride the same placement: the tiny edge detector is
# replicated, so streams can spread over the model axis too.
SINGLE_POD_RULES_DP = AxisRules(
    {"batch": ("data", "model"), "fsdp": (), "tensor": (), "seq_kv": (),
     "expert": (), "stream": ("data", "model")}
)
MULTI_POD_RULES_DP = AxisRules(
    {"batch": ("pod", "data", "model"), "fsdp": (), "tensor": (),
     "seq_kv": (), "expert": (), "stream": ("pod", "data", "model")}
)

_NAMED_RULES = {
    ("single", "baseline"): SINGLE_POD_RULES,
    ("multi", "baseline"): MULTI_POD_RULES,
    ("single", "ep"): SINGLE_POD_RULES_EP,
    ("multi", "ep"): MULTI_POD_RULES_EP,
    ("multi", "fsdp_pod"): MULTI_POD_RULES_FSDP_POD,
    ("single", "kvrep"): SINGLE_POD_RULES_KVREP,
    ("multi", "kvrep"): MULTI_POD_RULES_KVREP,
    ("single", "dp"): SINGLE_POD_RULES_DP,
    ("multi", "dp"): MULTI_POD_RULES_DP,
    # fast_train*: baseline rules + config overrides (bf16 grad accum,
    # capacity factor 1.0; fast_train4 also halves grad-accum microbatches)
    ("single", "fast_train"): SINGLE_POD_RULES,
    ("multi", "fast_train"): MULTI_POD_RULES,
    ("single", "fast_train4"): SINGLE_POD_RULES,
    ("multi", "fast_train4"): MULTI_POD_RULES,
    # kvint8: baseline rules + int8 KV cache (a config override)
    ("single", "kvint8"): SINGLE_POD_RULES,
    ("multi", "kvint8"): MULTI_POD_RULES,
}


def make_axis_rules(multi_pod: bool, variant: str = "baseline") -> AxisRules:
    return _NAMED_RULES[("multi" if multi_pod else "single", variant)]


def logical_to_spec(
    logical_axes: Sequence[str | None],
    rules: AxisRules,
    shape: Sequence[int] | None = None,
) -> P:
    """Translate per-dim logical names into a partition spec (trailing
    replicated entries stripped).  ``shape`` is accepted for the
    reference's signature; :func:`validated_spec` demotes dimensions that
    do not divide over their mesh axes."""
    parts = []
    for name in logical_axes:
        axes = rules.mesh_axes(name)
        if len(axes) == 0:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(tuple(axes))
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= mesh.shape[a]
        return n
    return mesh.shape[entry]


def validated_spec(spec: P, shape: Sequence[int], mesh) -> P:
    """Demote non-divisible dims to replicated.  ``mesh`` needs only a
    ``shape`` mapping of axis name -> size."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, parts):
        n = _axis_size(mesh, entry)
        out.append(entry if (n > 1 and dim % n == 0) or n == 1 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def named_sharding(mesh, logical_axes: Sequence[str | None],
                   rules: AxisRules, shape: Sequence[int] | None = None):
    """The placement of a tensor with these logical axes: its spec under
    ``rules``, validated against ``shape`` when given."""
    from repro_torch.distributed.mesh import NamedSharding
    spec = logical_to_spec(logical_axes, rules)
    if shape is not None:
        spec = validated_spec(spec, shape, mesh)
    return NamedSharding(mesh, spec)


def tree_shardings(mesh, specs_tree, rules: AxisRules):
    """A nested dict of ``ParamSpec`` -> the same nesting of
    ``NamedSharding``."""
    from repro_torch.models.params import ParamSpec
    if isinstance(specs_tree, ParamSpec):
        return named_sharding(mesh, specs_tree.axes, rules, specs_tree.shape)
    return {k: tree_shardings(mesh, v, rules) for k, v in specs_tree.items()}
