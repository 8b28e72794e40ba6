"""Inference steps and real inputs for the decoder-LM family (port of the
LM inference part of ``repro.launch.steps``).

``make_infer_fn(arch, case)`` returns the prefill or decode step;
``materialize(generator, arch, case)`` makes real parameters and inputs
for it on the resolved device.  The reference's ``build_cell`` and
``batch_specs`` describe abstract, sharded arrays for its dry run and
wait with that tooling; the other families and training wait for their
slices (ROADMAP.md queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchSpec, ShapeCase
from repro_torch.device import resolve_device
from repro_torch.models import params as PM
from repro_torch.models import transformer_lm as M


def _lm_only(arch: ArchSpec, case: ShapeCase) -> None:
    if arch.family != "lm" or case.kind not in ("prefill", "decode"):
        raise NotImplementedError(
            f"{arch.arch_id} {case.kind}: only LM prefill and decode are "
            "ported (ROADMAP.md queue 1)")


def make_infer_fn(arch: ArchSpec, case: ShapeCase):
    """prefill: ``fn(params, batch) -> (last logits, (k, v))``; decode:
    ``fn(params, cache, batch) -> (logits, cache)``, the cache updated in
    place (:func:`repro_torch.models.transformer_lm.decode_step`)."""
    _lm_only(arch, case)
    cfg = arch.cfg
    if case.kind == "prefill":
        return lambda params, batch: M.prefill_step(params, cfg,
                                                    batch["tokens"])
    return lambda params, cache, batch: M.decode_step(
        params, cfg, cache, batch["tokens"], batch["pos"])


def materialize(generator: torch.Generator, arch: ArchSpec,
                case: ShapeCase, device=None):
    """Real parameters and inputs on the resolved device, drawn from
    ``generator`` (which must live there): parameters first, then tokens.

    prefill: ``(params, {"tokens": (B, S) int32})``; decode: ``(params,
    cache, {"tokens": (B, 1) int32, "pos": min(7, S - 1)})`` with an empty
    cache (every ``slot_pos`` -1), as the reference's ``steps.py:322-327``.
    """
    _lm_only(arch, case)
    dev = resolve_device(device)
    cfg = arch.cfg
    params = PM.init_params(generator, M.param_specs(cfg), dev)
    B = case.batch
    if case.kind == "prefill":
        toks = torch.randint(0, cfg.vocab, (B, case.seq_len),
                             generator=generator, device=dev,
                             dtype=torch.int32)
        return params, {"tokens": toks}
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, 1),
                                     generator=generator, device=dev,
                                     dtype=torch.int32),
             "pos": min(7, case.seq_len - 1)}
    cache = PM.init_params(generator, M.init_cache_specs(cfg, B,
                                                         case.seq_len), dev)
    cache["slot_pos"].fill_(-1)
    return params, cache, batch
