"""Step builders and real inputs for the decoder-LM family (port of the
LM part of ``repro.launch.steps``): the training step with microbatches,
prefill and decode.

``build_cell(arch, case)`` returns a :class:`Cell` whose ``fn`` is the
step and whose ``args`` are tensors on the ``meta`` device with the
reference's shapes and dtypes (nothing allocated).  ``materialize
(generator, arch, case)`` makes real parameters and inputs for it on the
resolved device.  The reference's shardings and ``batch_specs`` feed its
dry run (ROADMAP.md queue 5); the vision and diffusion families wait for
their slice (ROADMAP.md queue 3).

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
from repro_torch.models import params as PM
from repro_torch.models import transformer_lm as M
from repro_torch.train import optimizer as OPT

i32 = torch.int32
f32 = torch.float32

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


def _lm_only(arch: ArchSpec) -> None:
    if arch.family != "lm":
        raise NotImplementedError(
            f"{arch.arch_id}: the {arch.family} family is not ported yet "
            "(ROADMAP.md queue 3)")


def _grads_of(cfg, params, batch):
    """(loss, d loss / d params) by autograd; the gradients in the
    parameters' dtypes and nesting."""
    p = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = PM.tree_leaves(p)
    loss = M.loss_fn(p, cfg, batch)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), PM.tree_map(lambda t: grads[id(t)], p)


def make_train_fn(arch: ArchSpec, grad_accum: int = 1):
    """``step(state, batch) -> (state, {"loss", "grad_norm", "lr"})`` with
    state ``{"params", "opt"}``.  With ``grad_accum`` > 1 the batch is
    split on dimension 0 into microbatches, run one after another; their
    gradients are summed in ``GRAD_ACCUM_DTYPE`` and, with the loss,
    divided by ``grad_accum`` before the AdamW update (``ADAMW``)."""
    _lm_only(arch)
    cfg = arch.cfg

    def train_step(state, batch):
        params = state["params"]
        if grad_accum == 1:
            loss, grads = _grads_of(cfg, params, batch)
        else:
            acc_dt = GRAD_ACCUM_DTYPE
            gsum = PM.tree_map(lambda t: torch.zeros(
                t.shape, dtype=acc_dt, device=t.device), params)
            lsum = 0.0
            for i in range(grad_accum):
                mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, g = _grads_of(cfg, params, mb)
                with torch.no_grad():
                    PM.tree_map(lambda a, x: a.add_(x.to(acc_dt)), gsum, g)
                lsum = lsum + loss
            grads = PM.tree_map(lambda t: t / grad_accum, gsum)
            loss = lsum / grad_accum
        new_p, new_opt, metrics = OPT.apply_updates(params, grads,
                                                    state["opt"], ADAMW)
        return {"params": new_p, "opt": new_opt}, {"loss": loss, **metrics}
    return train_step


def make_infer_fn(arch: ArchSpec, case: ShapeCase):
    """prefill: ``fn(params, batch) -> (last logits, (k, v))``; decode:
    ``fn(params, cache, batch) -> (logits, cache)``, the cache updated in
    place (:func:`repro_torch.models.transformer_lm.decode_step`)."""
    _lm_only(arch)
    if case.kind not in ("prefill", "decode"):
        raise NotImplementedError(
            f"{case.kind}: an LM has a prefill or a decode step here; "
            "training goes through make_train_fn")
    cfg = arch.cfg
    if case.kind == "prefill":
        return lambda params, batch: M.prefill_step(params, cfg,
                                                    batch["tokens"])
    return lambda params, cache, batch: M.decode_step(
        params, cfg, cache, batch["tokens"], batch["pos"])


def _meta(specs_tree):
    """Meta tensors of every spec's shape and dtype."""
    if isinstance(specs_tree, PM.ParamSpec):
        return torch.empty(specs_tree.shape, dtype=specs_tree.dtype,
                           device="meta")
    return {k: _meta(v) for k, v in specs_tree.items()}


def build_cell(arch: ArchSpec, case: ShapeCase) -> Cell:
    """The step of (arch, case) and meta tensors for its arguments, as the
    reference's ``build_cell`` without a mesh."""
    _lm_only(arch)
    cfg = arch.cfg
    name = f"{arch.arch_id}:{case.name}"
    params = _meta(M.param_specs(cfg))
    B = case.batch

    def toks(S):
        return torch.empty((B, S), dtype=i32, device="meta")

    if case.kind == "train":
        state = {"params": params, "opt": OPT.init_state(params)}
        batch = {"tokens": toks(case.seq_len), "labels": toks(case.seq_len)}
        return Cell(name, make_train_fn(arch, grad_accum=case.grad_accum),
                    (state, batch), donate=(0,), kind="train")
    fn = make_infer_fn(arch, case)
    if case.kind == "decode":
        cache = _meta(M.init_cache_specs(cfg, B, case.seq_len))
        batch = {"tokens": toks(1),
                 "pos": torch.empty((), dtype=i32, device="meta")}
        return Cell(name, fn, (params, cache, batch), donate=(1,),
                    kind="decode")
    return Cell(name, fn, (params, {"tokens": toks(case.seq_len)}),
                donate=(), kind=case.kind)


def materialize(generator: torch.Generator, arch: ArchSpec,
                case: ShapeCase, device=None):
    """Real parameters and inputs on the resolved device, drawn from
    ``generator`` (which must live there): parameters first, then tokens.

    train: ``({"params", "opt"}, {"tokens", "labels"})``, the labels the
    tokens rolled one place left and the optimiser state zero; prefill:
    ``(params, {"tokens": (B, S) int32})``; decode: ``(params, cache,
    {"tokens": (B, 1) int32, "pos": min(7, S - 1)})`` with an empty cache
    (every ``slot_pos`` -1), as the reference's ``steps.py:301-327``.
    """
    _lm_only(arch)
    if case.kind not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"{case.kind}: not an LM case")
    dev = resolve_device(device)
    cfg = arch.cfg
    params = PM.init_params(generator, M.param_specs(cfg), dev)
    B = case.batch
    if case.kind in ("train", "prefill"):
        toks = torch.randint(0, cfg.vocab, (B, case.seq_len),
                             generator=generator, device=dev, dtype=i32)
        if case.kind == "prefill":
            return params, {"tokens": toks}
        return ({"params": params, "opt": OPT.init_state(params)},
                {"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, 1),
                                     generator=generator, device=dev,
                                     dtype=i32),
             "pos": min(7, case.seq_len - 1)}
    cache = PM.init_params(generator, M.init_cache_specs(cfg, B,
                                                         case.seq_len), dev)
    cache["slot_pos"].fill_(-1)
    return params, cache, batch
