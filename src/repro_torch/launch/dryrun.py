"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (arch x
shape x mesh) cell laid out, and its step walked, on the ``meta`` device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b \
        --shape train_4k --mesh single --out experiments/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Every other entry point of the port runs on the card.  The dry run runs
on ``meta`` on any machine, card or none: like the reference's, which
lowers and compiles a cell without running it, it allocates nothing and
computes no value.  The production meshes
(:func:`repro_torch.launch.mesh.make_production_mesh`) name 256 or 512
meta devices, a logical mesh that holds shapes.

The record of a cell, one JSON file in ``--out`` under the reference's
name:

* ``memory.argument_size_in_bytes``: per device, the bytes of every
  argument's ``shard_shape`` on the mesh (a replicated argument whole),
  equal to the reference's;
* ``memory.output_size_in_bytes``: per device.  The step's i-th result
  replaces its i-th argument where that argument is donated (the train
  state, the decode cache), and each of its leaves keeps the placement
  of the argument's leaf at the same path, shape and dtype.  Any other
  output is counted whole: the port partitions no step, so it places
  none;
* ``cost``: counts over one walk of the whole step on meta, forward,
  recomputed blocks, backward and AdamW.  ``flops`` from
  ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  convolutions and attention kernels), ``bytes accessed`` the input and
  output bytes of every operator that is not a view (what an eager step
  moves), ``transcendentals`` the output elements of exp, log, tanh,
  sigmoid, rsqrt, erf, sin and cos (softmax, SiLU and GELU are operators
  of their own and not counted).  ``cost_global`` holds the whole step's
  counts and ``cost`` them divided evenly over the mesh's devices.  A
  meta convolution returns NCHW-contiguous output where the card's is
  channels-last, so ConvNeXt's pointwise products fold into ``bmm`` here
  and ``mm`` there (``flops_by_op``; the same FLOPs), and the folds'
  copies add to its bytes.  A mesh of meta devices runs no shard
  (``ShardCtx.runs_shards``), so the MoE cells count ``moe_block``'s
  local branch, not the expert-parallel one a mesh of cards would run;
* ``cost_method``: ``probe_extrapolation(L=2,4)`` for the homogeneous
  families (the LMs, DiT, ViT) deeper than the two probes together
  (cost(L) = cost(2) + (L - 2) / 2 * (cost(4) - cost(2)), in integers:
  every layer walks the same operators), else ``full_walk``;
* ``layout_s``, the seconds to lay out the cell (in place of the
  reference's ``compile_s``), and ``total_s`` with the walks.

The walk runs under ``shard_ctx(mesh, rules)``, so every ``constrain``
places its activation's logical axes on the mesh and raises where the
reference's compile would.  Not ported: ``parse_collectives`` and
``wire_bytes`` (the port makes no HLO and partitions nothing, so it has
no collective to count), and ``memory_analysis``'s temp, alias and
generated-code sizes (XLA's buffer assignment; the card's peak memory is
the port's counterpart).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ALIASES, all_cells, get_arch
from repro_torch.distributed.context import shard_ctx
from repro_torch.distributed.sharding import make_axis_rules
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh, production_shape

_TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "rsqrt", "erf", "sin",
                   "cos"}
_COSTS = ("flops", "bytes accessed", "transcendentals")


class _Traffic(TorchDispatchMode):
    """Bytes in and out of every operator that is not a view, and the
    output elements of the transcendental ones."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs, out)))
            if func.overloadpacket.__name__.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel()
                                            for t in _tensors(out))
        return out


def _tensors(tree) -> list:
    return [t for _, t in path_leaves(tree) if isinstance(t, torch.Tensor)]


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``torch.utils.flop_counter``'s bmm formula, taking the f32-result
    overload ``bmm(a, b, out_dtype)`` that ``layers.mm_f32`` calls on the
    card (the library's formula has no room for its third argument)."""
    b, m, k = a_shape
    return b * m * b_shape[2] * 2 * k


def flop_counter() -> FlopCounterMode:
    """A ``FlopCounterMode`` (no display) that also counts the card's
    f32-result bmm."""
    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.bmm: _bmm_flop})


def path_leaves(tree, prefix=()):
    """(path, leaf) of a nest of dicts, lists and tuples, None left out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from path_leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from path_leaves(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _shard_bytes(sds) -> int:
    return math.prod(sds.shard_shape()) * sds.dtype.itemsize


def walk(cell, mesh, rules) -> dict:
    """``cell.fn(*cell.args)`` once, under ``shard_ctx(mesh, rules)``: the
    whole step's "flops", "bytes accessed" and "transcendentals", the
    per-device "output bytes" (the module docstring's rule) and
    "flops_by_op", the FLOPs by operator."""
    traffic = _Traffic()
    with flop_counter() as flops, traffic, shard_ctx(mesh, rules):
        out = cell.fn(*cell.args)
    return {"flops": flops.get_total_flops(),
            "bytes accessed": traffic.bytes,
            "transcendentals": traffic.transcendentals,
            "output bytes": output_bytes(cell, out),
            "flops_by_op": {str(op): n for op, n in flops.get_flop_counts()
                            .get("Global", {}).items()}}


def output_bytes(cell, out) -> int:
    """Per-device bytes of the step's output (the module docstring's
    rule)."""
    total = 0
    for i, result in enumerate(out):
        kept = dict(path_leaves(cell.abstract[i])) if i in cell.donate \
            else {}
        for path, t in path_leaves(result):
            if not isinstance(t, torch.Tensor):
                continue
            sds = kept.get(path)
            if sds is not None and tuple(t.shape) == tuple(sds.shape) \
                    and t.dtype == sds.dtype:
                total += _shard_bytes(sds)
            else:
                total += t.numel() * t.element_size()
    return total


def _with_layers(arch, n: int):
    """Probe config with n layers; the homogeneous families only."""
    cfg = dataclasses.replace(arch.cfg, n_layers=n)
    return dataclasses.replace(arch, cfg=cfg)


def _homogeneous(arch) -> bool:
    return arch.family in ("lm", "diffusion") or \
        arch.cfg.__class__.__name__ == "ViTConfig"


def probe_walk(arch, case, mesh, rules) -> dict:
    """:func:`walk`'s record at ``arch.cfg.n_layers`` layers extrapolated
    from walks at 2 and 4: every layer walks the same operators and adds
    the same outputs, so each count is linear in the depth and the
    extrapolation exact."""
    r2, r4 = (walk(steps_mod.build_cell(_with_layers(arch, n), case, mesh,
                                        rules), mesh, rules)
              for n in (2, 4))
    L = arch.cfg.n_layers

    def extrapolate(a, b):
        return a + (L - 2) * (b - a) // 2

    rec = {k: extrapolate(r2[k], r4[k]) for k in r2 if k != "flops_by_op"}
    rec["flops_by_op"] = {
        op: extrapolate(r2["flops_by_op"].get(op, 0), n)
        for op, n in r4["flops_by_op"].items()}
    return rec


def layout(arch, case, mesh, rules) -> dict:
    """The memory and cost record of one cell on ``mesh``."""
    t0 = time.perf_counter()
    cell = steps_mod.build_cell(arch, case, mesh, rules)
    rec = {"layout_s": round(time.perf_counter() - t0, 2)}
    # the two probes walk 6 layers: deeper models take them
    if _homogeneous(arch) and arch.cfg.n_layers > 6:
        costs = probe_walk(arch, case, mesh, rules)
        rec["cost_method"] = "probe_extrapolation(L=2,4)"
    else:
        costs = walk(cell, mesh, rules)
        rec["cost_method"] = "full_walk"
    rec["memory"] = {
        "argument_size_in_bytes": sum(
            _shard_bytes(s) for _, s in path_leaves(cell.abstract)),
        "output_size_in_bytes": costs.pop("output bytes"),
    }
    rec["flops_by_op"] = costs.pop("flops_by_op")
    rec["cost_global"] = costs
    rec["cost"] = {k: costs[k] / mesh.size for k in _COSTS}
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def _apply_variant_overrides(arch, variant: str):
    """Config-level hillclimb knobs (rules-level ones live in sharding.py)."""
    if variant == "kvint8":
        if arch.family == "lm":
            arch = dataclasses.replace(
                arch, cfg=dataclasses.replace(arch.cfg,
                                              kv_cache_dtype="int8"))
        steps_mod.set_grad_accum_dtype(torch.float32)
    elif variant.startswith("fast_train"):
        steps_mod.set_grad_accum_dtype(torch.bfloat16)
        if arch.family == "lm" and arch.cfg.moe is not None:
            moe = dataclasses.replace(arch.cfg.moe, capacity_factor=1.0)
            arch = dataclasses.replace(
                arch, cfg=dataclasses.replace(arch.cfg, moe=moe))
        if variant == "fast_train4":
            # halve the microbatch count: halves a step's weight gathers
            # and gradient reductions, costs 2x activation memory
            shapes = {k: (dataclasses.replace(v, grad_accum=4)
                          if v.kind == "train" and v.grad_accum > 4 else v)
                      for k, v in arch.shapes.items()}
            arch = dataclasses.replace(arch, shapes=shapes)
    else:
        steps_mod.set_grad_accum_dtype(torch.float32)
    return arch


def meta_mesh(mesh_kind: str):
    """The production mesh of ``mesh_kind`` (single | multi | degraded)
    over meta devices."""
    kw = dict(multi_pod=mesh_kind == "multi",
              degraded=mesh_kind == "degraded")
    shape, _ = production_shape(**kw)
    return make_production_mesh(
        **kw, devices=[torch.device("meta")] * math.prod(shape))


def run_cell(arch_id: str, shape: str, mesh_kind: str, variant: str,
             out_dir: str | None) -> dict:
    arch = get_arch(arch_id)
    case = arch.shapes[shape]
    rec = {"arch": ALIASES.get(arch_id, arch_id), "shape": shape,
           "mesh": mesh_kind, "variant": variant}
    if case.skip:
        rec["status"] = "skipped"
        rec["reason"] = case.skip
        _dump(rec, out_dir)
        return rec

    mesh = meta_mesh(mesh_kind)
    rules = make_axis_rules(mesh_kind == "multi", variant)
    arch = _apply_variant_overrides(arch, variant)
    case = arch.shapes[shape]          # re-fetch: overrides may change it
    rec["mesh_shape"] = dict(mesh.shape)
    rec["n_devices"] = mesh.size
    rec.update(layout(arch, case, mesh, rules))
    rec["status"] = "ok"
    _dump(rec, out_dir)
    return rec


def _dump(rec, out_dir):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__"
                 f"{rec['variant']}.json".replace("/", "_"))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "degraded"],
                    default="single")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for a, s, skip in all_cells():
            print(f"{a}\t{s}\t{'SKIP:' + skip if skip else 'run'}")
        return
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, args.variant,
                       args.out)
        print(json.dumps(rec, indent=1))
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "variant": args.variant, "status": "error",
               "error": traceback.format_exc()}
        _dump(rec, args.out)
        print(json.dumps(rec, indent=1))
        raise SystemExit(1)


if __name__ == "__main__":
    main()
