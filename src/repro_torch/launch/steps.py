"""Step builders and real inputs for every (architecture x shape) cell
(port of ``repro.launch.steps``): the training step (microbatches for the
families without batch statistics; ResNet's step returns its new
``batch_stats``), LM prefill and decode, the vision forward and the
diffusion DDIM step.

``build_cell(arch, case, mesh, rules)`` returns a :class:`Cell` whose
``fn`` is the step, whose ``abstract`` arguments are
``ShapeDtypeStruct``s with the reference's shapes, dtypes and, under a
mesh, placements (``batch_specs`` gives the inputs' logical axes), and
whose ``args`` are tensors on the ``meta`` device of those shapes and
dtypes (nothing allocated): the dry run
(:mod:`repro_torch.launch.dryrun`) walks ``fn(*args)``.  ``materialize
(generator, arch, case)`` makes real parameters and inputs for it on the
resolved device.

The backward is autograd through the plain PyTorch path: no kernel of
the reference or the port has a backward (``attention_impl="pallas"``
raises under autograd).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ArchSpec, ShapeCase
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import ShapeDtypeStruct
from repro_torch.distributed.sharding import AxisRules, named_sharding
from repro_torch.models import convnext, dit, resnet, transformer_lm, vit
from repro_torch.models import layers as L
from repro_torch.models import params as PM
from repro_torch.train import optimizer as OPT

i32 = torch.int32
f32 = torch.float32
bf16 = torch.bfloat16

ADAMW = OPT.AdamWConfig()

# the dtype of the microbatch gradient accumulators (the reference's
# fast_train knob: bf16 halves a data-parallel reduction's payload)
GRAD_ACCUM_DTYPE = f32


def set_grad_accum_dtype(dt):
    global GRAD_ACCUM_DTYPE
    GRAD_ACCUM_DTYPE = dt


@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable
    args: tuple
    donate: tuple[int, ...]
    kind: str
    abstract: tuple = ()


def _sds(shape, dtype, axes, mesh, rules) -> ShapeDtypeStruct:
    sh = None if mesh is None else named_sharding(mesh, axes, rules, shape)
    return ShapeDtypeStruct(tuple(shape), dtype, sh)


def _model(arch: ArchSpec):
    """The module of the arch's family (and, for vision, its config)."""
    if arch.family == "lm":
        return transformer_lm
    if arch.family == "diffusion":
        return dit
    vision = {resnet.ResNetConfig: resnet, convnext.ConvNeXtConfig: convnext,
              vit.ViTConfig: vit}
    if type(arch.cfg) not in vision:
        raise ValueError(f"{arch.arch_id}: no {arch.family} model takes a "
                         f"{type(arch.cfg).__name__}")
    return vision[type(arch.cfg)]


def _is_resnet(arch: ArchSpec) -> bool:
    return _model(arch) is resnet


def _specs_tree(arch: ArchSpec) -> dict:
    return _model(arch).param_specs(arch.cfg)


def batch_specs(arch: ArchSpec, case: ShapeCase, mesh,
                rules: AxisRules | None) -> dict:
    """A cell's inputs as ``ShapeDtypeStruct``s, the reference's: the
    batch dimension on the logical axis "batch", the rest replicated;
    decode's ``pos`` a replicated 0-d int32."""
    cfg = arch.cfg
    B = case.batch

    def sds(shape, dtype):
        return _sds(shape, dtype, ("batch",) + (None,) * (len(shape) - 1),
                    mesh, rules)

    if arch.family == "lm":
        if case.kind == "decode":
            return {"tokens": sds((B, 1), i32),
                    "pos": ShapeDtypeStruct((), i32)}
        out = {"tokens": sds((B, case.seq_len), i32)}
        if case.kind == "train":
            out["labels"] = sds((B, case.seq_len), i32)
        return out
    if arch.family == "diffusion":
        lr = cfg.latent_res(case.img_res)
        lat = (B, lr, lr, cfg.latent_channels)
        if case.kind == "train":
            return {"latents": sds(lat, f32), "noise": sds(lat, f32),
                    "t": sds((B,), i32), "labels": sds((B,), i32)}
        return {"xt": sds(lat, f32), "t": sds((B,), i32),
                "t_prev": sds((B,), i32), "y": sds((B,), i32)}
    r = case.img_res
    out = {"images": sds((B, r, r, 3), bf16)}
    if case.kind == "train":
        out["labels"] = sds((B,), i32)
    return out


def _grads_of(loss_fn, params, batch):
    """(loss, d loss / d params, aux) by autograd for ``loss_fn(params,
    batch) -> (loss, aux)``; the gradients in the parameters' dtypes and
    nesting, zero for a parameter the loss does not read (DiT's
    ``final_ln_w``, as ``jax.grad`` gives it)."""
    p = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = PM.tree_leaves(p)
    loss, aux = loss_fn(p, batch)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)))
    return loss.detach(), PM.tree_map(lambda t: grads[id(t)], p), aux


def make_train_fn(arch: ArchSpec, grad_accum: int = 1):
    """``step(state, batch) -> (state, {"loss", "grad_norm", "lr"})`` with
    state ``{"params", "opt"}`` (and ResNet's ``"batch_stats"``).  With
    ``grad_accum`` > 1 the batch is split on dimension 0 into
    microbatches, run one after another; their gradients are summed in
    ``GRAD_ACCUM_DTYPE`` and, with the loss, divided by ``grad_accum``
    before the AdamW update (``ADAMW``).  ResNet's step takes the whole
    batch whatever ``grad_accum`` says, as the reference's, and returns
    the running stats its forward moved."""
    cfg = arch.cfg
    M = _model(arch)

    if _is_resnet(arch):
        def resnet_step(state, batch):
            loss, grads, new_st = _grads_of(
                lambda p, b: M.loss_fn({"params": p, "batch_stats":
                                        state["batch_stats"]}, cfg, b),
                state["params"], batch)
            new_p, new_opt, metrics = OPT.apply_updates(
                state["params"], grads, state["opt"], ADAMW)
            return ({"params": new_p, "opt": new_opt,
                     "batch_stats": PM.tree_map(torch.Tensor.detach,
                                                new_st)},
                    {"loss": loss, **metrics})
        return resnet_step

    def loss(p, b):
        return M.loss_fn(p, cfg, b), None

    def train_step(state, batch):
        params = state["params"]
        if grad_accum == 1:
            loss_v, grads, _ = _grads_of(loss, params, batch)
        else:
            acc_dt = GRAD_ACCUM_DTYPE
            gsum = PM.tree_map(lambda t: torch.zeros(
                t.shape, dtype=acc_dt, device=t.device), params)
            lsum = 0.0

            def split(x):
                y = x.reshape(grad_accum, x.shape[0] // grad_accum,
                              *x.shape[1:])
                return L.constrain(y, None, "batch",
                                   *([None] * (y.ndim - 2)))

            mbs = {k: split(v) for k, v in batch.items()}
            for i in range(grad_accum):
                mb = {k: v[i] for k, v in mbs.items()}
                loss_v, g, _ = _grads_of(loss, params, mb)
                with torch.no_grad():
                    PM.tree_map(lambda a, x: a.add_(x.to(acc_dt)), gsum, g)
                lsum = lsum + loss_v
            grads = PM.tree_map(lambda t: t / grad_accum, gsum)
            loss_v = lsum / grad_accum
        new_p, new_opt, metrics = OPT.apply_updates(params, grads,
                                                    state["opt"], ADAMW)
        return {"params": new_p, "opt": new_opt}, {"loss": loss_v, **metrics}
    return train_step


def make_infer_fn(arch: ArchSpec, case: ShapeCase):
    """LM prefill: ``fn(params, batch) -> (last logits, (k, v))``; LM
    decode: ``fn(params, cache, batch) -> (logits, cache)``, the cache
    updated in place (:func:`repro_torch.models.transformer_lm.
    decode_step`); vision: ``fn(params, batch) -> logits`` (ResNet's
    params ``{"params", "batch_stats"}``, eval mode); diffusion: ``fn(
    params, batch) -> x_{t_prev}``, one DDIM step; both without
    autograd."""
    cfg = arch.cfg
    M = _model(arch)
    if arch.family == "lm":
        if case.kind == "prefill":
            return lambda params, batch: M.prefill_step(params, cfg,
                                                        batch["tokens"])
        if case.kind == "decode":
            def decode(params, cache, batch):
                pos = batch["pos"]
                if isinstance(pos, torch.Tensor) and pos.is_meta:
                    # a meta position has no value: the walk on meta
                    # decodes at materialize's position
                    pos = min(7, case.seq_len - 1)
                return M.decode_step(params, cfg, cache, batch["tokens"],
                                     pos)
            return decode
        raise NotImplementedError(
            f"{case.kind}: an LM has a prefill or a decode step here; "
            "training goes through make_train_fn")
    if case.kind == "train":
        raise NotImplementedError(
            f"{case.kind}: training goes through make_train_fn")
    if arch.family == "diffusion":
        def fn(params, batch):
            return M.ddim_step(params, cfg, batch["xt"], batch["t"],
                               batch["t_prev"], batch["y"])
    elif M is resnet:
        def fn(variables, batch):
            return M.forward(variables, cfg, batch["images"],
                             train=False)[0]
    else:
        def fn(params, batch):
            return M.forward(params, cfg, batch["images"])
    # inference records no graph (and so recomputes no block)
    return torch.no_grad()(fn)


def _meta(tree):
    """Meta tensors in place of every ``ShapeDtypeStruct`` of ``tree``."""
    if isinstance(tree, ShapeDtypeStruct):
        return tree.meta()
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return tuple(_meta(v) for v in tree)


def _params_and_stats(arch: ArchSpec, make):
    """(params, ResNet's batch_stats or None), each spec tree through
    ``make``."""
    specs = _specs_tree(arch)
    if _is_resnet(arch):
        return make(specs["params"]), make(specs["batch_stats"])
    return make(specs), None


def _cell_args(case: ShapeCase, params, stats, batch, opt) -> tuple:
    """A cell's arguments but a decode's: train ``(state, batch)``, the
    state ``{"params", "opt"}`` and ResNet's ``"batch_stats"``; else
    ``(params, batch)``, ResNet's params ``{"params", "batch_stats"}``."""
    if case.kind == "train":
        state = {"params": params, "opt": opt}
        if stats is not None:
            state["batch_stats"] = stats
        return state, batch
    if stats is not None:
        return {"params": params, "batch_stats": stats}, batch
    return params, batch


def build_cell(arch: ArchSpec, case: ShapeCase, mesh=None,
               rules: AxisRules | None = None) -> Cell:
    """The step of (arch, case), its arguments as ``ShapeDtypeStruct``s
    placed on ``mesh`` by ``rules`` (unplaced without a mesh), and meta
    tensors of their shapes and dtypes, as the reference's
    ``build_cell``.  A decode step given a meta ``pos`` decodes at
    :func:`materialize`'s position."""
    name = f"{arch.arch_id}:{case.name}"
    params, stats = _params_and_stats(
        arch, lambda specs: PM.abstract_params(specs, mesh, rules))
    batch = batch_specs(arch, case, mesh, rules)
    if case.kind == "train":
        abstract = _cell_args(case, params, stats, batch,
                              OPT.abstract_state(params))
        fn, donate = make_train_fn(arch, grad_accum=case.grad_accum), (0,)
    elif case.kind == "decode":
        cache = PM.abstract_params(transformer_lm.init_cache_specs(
            arch.cfg, case.batch, case.seq_len), mesh, rules)
        abstract = (params, cache, batch)
        fn, donate = make_infer_fn(arch, case), (1,)
    else:
        abstract = _cell_args(case, params, stats, batch, None)
        fn, donate = make_infer_fn(arch, case), ()
    return Cell(name, fn, _meta(abstract), donate=donate, kind=case.kind,
                abstract=abstract)


def materialize(generator: torch.Generator, arch: ArchSpec,
                case: ShapeCase, device=None):
    """Real parameters and inputs on the resolved device, drawn from
    ``generator`` (which must live there): parameters first, then the
    inputs, in the arguments' structure of :func:`build_cell`; the
    optimiser state and ResNet's batch_stats start as the reference's
    (zero moments and step, zero means, unit variances).

    LM: seeded tokens, train's labels the tokens rolled one place left;
    decode: ``(params, cache, {"tokens": (B, 1) int32, "pos": min(7, S -
    1)})`` with an empty cache (every ``slot_pos`` -1), as the reference's
    ``steps.py:301-327``.  Vision: N(0, 1) bf16 images and zero labels;
    diffusion: N(0, 1) latents (and noise), t 500 (and t_prev 480), zero
    labels.
    """
    if arch.family == "lm" and case.kind not in ("train", "prefill",
                                                 "decode"):
        raise NotImplementedError(f"{case.kind}: not an LM case")
    dev = resolve_device(device)
    cfg = arch.cfg
    params, stats = _params_and_stats(
        arch, lambda specs: PM.init_params(generator, specs, dev))
    batch = {}
    for k, sds in batch_specs(arch, case, None, None).items():
        shape, dt = sds.shape, sds.dtype
        if k == "pos":
            batch[k] = min(7, case.seq_len - 1)
        elif k == "tokens":
            batch[k] = torch.randint(0, cfg.vocab, shape, generator=generator,
                                     device=dev, dtype=i32)
        elif k == "labels" and arch.family == "lm":
            batch[k] = torch.roll(batch["tokens"], -1, 1)
        elif dt == i32:
            batch[k] = torch.full(shape, {"t": 500, "t_prev": 480}.get(
                k, 0), dtype=i32, device=dev)
        else:
            batch[k] = torch.randn(shape, generator=generator,
                                   device=dev).to(dt)
    if case.kind == "decode":
        cache = PM.init_params(generator, transformer_lm.init_cache_specs(
            cfg, case.batch, case.seq_len), dev)
        cache["slot_pos"].fill_(-1)
        return params, cache, batch
    opt = OPT.init_state(params) if case.kind == "train" else None
    return _cell_args(case, params, stats, batch, opt)
