"""The port's mixture of experts on the CPU against the JAX package: the
router, the sorted and gathered expert paths, ``moe_block`` local and
expert-parallel, reduced qwen2-moe-a2.7B and mixtral-8x22B (forward,
loss, prefill, decode past mixtral's window, one train step), their
configs and cells, and the placement of parameters by logical axes.  The
reference's weights are carried across by ``lm_params_from_jax``, and both
packages take the same seeded numpy inputs.

Tolerances.  Integer results are exact: the top-k indices (ties to the
lower index, as ``lax.top_k``), the capacity, the branch taken, the
sharded branch's routing.  The layers take the same bf16 inputs in both
packages; their f32 GEMMs sum in another order (MKL against Eigen), so a
bf16 expert output differs by one ulp now and then and the MoE outputs
are held to ``ULP_TOL`` (4 bf16 ulps) of their largest magnitude and to
``SAME_BITS`` of their elements bit for bit (measured: 1 to 2 ulps, at
least 0.999 equal).  The router's f32 weights and losses agree to 1e-6.
The whole models follow ``tests/test_torch_lm.py``: logits within 0.1
of their largest magnitude, greedy picks equal or near ties, caches
within 0.02; the router loss within 1e-2 (a routing decision after a
one-ulp difference in a layer's input moves it).  The sharded branch adds
the bf16 rounding of the tensor shards' partial sums, each rounded before
they are added, and a partial can be several times the sum where the d_ff
slices cancel: within 2^-5 of the largest output (measured here: 0.0085;
on the card, at qwen2-moe's layer 0, 0.0144), where a lost partial reads
0.87 and more (``test_expert_parallel_tolerance_sees_a_lost_partial``)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ShapeCase as JShapeCase
from repro.configs import get_arch as j_get_arch
from repro.distributed import sharding as JSH
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer_lm as JM
from repro.models.params import init_params as j_init_params
from repro.serving import elastic as JEL
from repro.train import checkpoint as JCKPT
from repro.train import optimizer as JO
from repro_torch.configs import ShapeCase, get_arch
from repro_torch.distributed import shard_map_compat as SMC
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import shard_ctx
from repro_torch.distributed.mesh import (NamedSharding, Placed, device_put,
                                          make_mesh)
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import params as PM
from repro_torch.models import transformer_lm as M
from repro_torch.models.weights import lm_params_from_jax
from repro_torch.serving import elastic as EL
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as OPT

ARCHS = ["qwen2_moe_a2_7b", "mixtral_8x22b"]
ULP_TOL = 4 * 2.0 ** -8
SAME_BITS = 0.999
LOGIT_TOL = 0.1
CACHE_TOL = 0.02
AUX_TOL = 1e-2
SHARD_TOL = 2.0 ** -5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.bfloat16):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


def _rel(ours, ref) -> float:
    ours, ref = _np(ours), _np(ref)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _hold_bf16(ours, ref):
    """A bf16 MoE output: within ULP_TOL of its scale, SAME_BITS equal."""
    ours, ref = _np(ours.float()), _np(ref)
    assert ours.shape == ref.shape
    assert _rel(ours, ref) <= ULP_TOL, _rel(ours, ref)
    assert (ours == ref).mean() >= SAME_BITS, (ours == ref).mean()


def _hold_logits(ours, ref):
    ours, ref = _np(ours), _np(ref)
    assert np.isfinite(ours).all()
    assert _rel(ours, ref) <= LOGIT_TOL, _rel(ours, ref)
    pick, pick_ref = ours.argmax(-1), ref.argmax(-1)
    gap = np.abs(np.take_along_axis(ref, pick_ref[..., None], -1)
                 - np.take_along_axis(ref, pick[..., None], -1)).max()
    assert gap <= np.abs(ours - ref).max(), gap


def _experts(rng, T, d, f, E):
    """Seeded tokens, router and expert weights (numpy, bf16 values)."""
    x = rng.standard_normal((T, d))
    wr = rng.standard_normal((d, E)) / np.sqrt(d)
    w1 = rng.standard_normal((E, d, f)) / np.sqrt(d)
    w3 = rng.standard_normal((E, d, f)) / np.sqrt(d)
    w2 = rng.standard_normal((E, f, d)) / np.sqrt(f)
    return [np.asarray(_j(a), np.float32) for a in (x, wr, w1, w3, w2)]


def _jit(fn):
    """A reference MoE function jitted, its config static (XLA gives the
    eager calls' bits, and compiles once instead of an op at a time)."""
    return jax.jit(fn, static_argnums=5)


def _cfgs(E, k, cf=1.25, norm=True):
    return (L.MoEConfig(E, k, cf, norm), JL.MoEConfig(E, k, cf, norm))


# ------------------------------------------------------------ the router
def test_router_topk_ties_to_the_lower_index():
    """Duplicate router columns and an all-zero token tie exactly: the
    indices equal ``lax.top_k``'s (the lower index first) in every row;
    the weights and the aux loss agree to f32 rounding."""
    rng = np.random.default_rng(0)
    x, wr, *_ = _experts(rng, 64, 16, 8, 8)
    wr[:, 5] = wr[:, 2]                   # experts 2 and 5 always tie
    wr[:, 7] = wr[:, 0]
    x[3] = 0.0                            # every expert ties
    for norm in (True, False):
        ours, ref = _cfgs(8, 4, norm=norm)
        idx, w, aux = L.router_topk(_t(x), _t(wr), ours)
        jidx, jw, jaux = JL.router_topk(_j(x), _j(wr), ref)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(idx[3].numpy(), [0, 1, 2, 3])
        assert w.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(w.float()), _np(jw), rtol=2 ** -8)
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    # torch.topk itself gives no such promise; the port sorts stably
    probs = torch.full((1, 8), 0.125)
    assert L._topk(probs, 3)[1].tolist() == [[0, 1, 2]]


@pytest.mark.parametrize("T,k,E,cf", [(8, 4, 60, 1.25), (15, 4, 60, 1.25),
                                      (64, 2, 8, 1.25), (37, 2, 4, 0.3),
                                      (12, 2, 8, 1.0), (48, 4, 60, 1.25),
                                      (4096, 4, 60, 1.25), (7, 2, 8, 4.0)])
def test_capacity_is_the_reference_expression(T, k, E, cf):
    """C = min(max(k, int(T·k·cf/E + 0.999)), T), the float expression of
    ``layers.py:309-310``; the drops it gives match the reference's
    (test_sorted_dispatch_with_drops)."""
    C = max(k, int(T * k * cf / E + 0.999))
    assert L.capacity(T, L.MoEConfig(E, k, cf)) == min(C, T)


# ------------------------------------------------------- the expert paths
@pytest.mark.parametrize("E,k,cf,T", [(8, 4, 1.25, 256), (8, 4, 0.5, 256),
                                      (60, 4, 1.25, 240), (4, 2, 0.3, 100)])
def test_sorted_dispatch_with_drops(E, k, cf, T):
    """``moe_sorted_dispatch`` against the reference, with drops when
    cf < 1 (the dropped (token, slot) pairs contribute 0 in both)."""
    x, wr, w1, w3, w2 = _experts(np.random.default_rng(E + T), T, 32, 16, E)
    ours, ref = _cfgs(E, k, cf)
    out, aux = L.moe_sorted_dispatch(*map(_t, (x, wr, w1, w3, w2)), ours)
    jout, jaux = _jit(JL.moe_sorted_dispatch)(*map(_j, (x, wr, w1, w3, w2)),
                                              ref)
    assert out.dtype == torch.bfloat16 and out.shape == (T, 32)
    _hold_bf16(out, jout)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    if cf < 1:
        # a token whose k slots all overflow gets exactly 0 in both
        zero = ~np.asarray(jout, np.float32).any(-1)
        assert zero.any()
        np.testing.assert_array_equal(~out.float().numpy().any(-1), zero)


def test_combine_adds_in_the_reference_order():
    """Each token's k weighted expert outputs go through the reference's
    scatter-add (``jnp.zeros(...).at[tok].add(contrib)``, layers.py:326)
    and through the port's combine: bit for bit.  Two other orders the
    port could take (slot order, f32 sums rounded once) part from it."""
    T, d, E, k = 200, 32, 8, 4
    rng = np.random.default_rng(5)
    x, wr, *_ = _experts(rng, T, d, 8, E)
    idx, w, _ = L.router_topk(_t(x), _t(wr), L.MoEConfig(E, k))
    contrib = _t(rng.standard_normal((T * k, d)))   # in sorted order
    order = torch.argsort(idx.reshape(-1), stable=True)
    ref = jnp.zeros((T, d), jnp.bfloat16).at[
        jnp.asarray((order // k).numpy())].add(_j(contrib.float()))
    ours = L._combine(contrib, order, idx)
    np.testing.assert_array_equal(ours.float().numpy(), _np(ref))
    by_slot = torch.empty_like(contrib)
    by_slot[order] = contrib
    by_slot = by_slot.reshape(T, k, d)
    slot_order = by_slot[:, 0]
    for j in range(1, k):
        slot_order = slot_order + by_slot[:, j]
    once = by_slot.float().sum(1).to(torch.bfloat16)
    for other in (slot_order, once):
        assert not np.array_equal(other.float().numpy(), _np(ref))


@pytest.mark.parametrize("E,k,T", [(60, 4, 2), (8, 2, 3), (4, 2, 1)])
def test_gathered_experts(E, k, T):
    x, wr, w1, w3, w2 = _experts(np.random.default_rng(T), T, 32, 16, E)
    ours, ref = _cfgs(E, k)
    out, aux = L.moe_gathered_experts(*map(_t, (x, wr, w1, w3, w2)), ours)
    jout, jaux = _jit(JL.moe_gathered_experts)(
        *map(_j, (x, wr, w1, w3, w2)), ref)
    _hold_bf16(out, jout)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("T", [3, 4, 5])
def test_local_branch_is_the_references(T):
    """T·k >= E takes the sorted dispatch, else the gathered path, as the
    reference's ``_moe_local``: the port's output is the reference's, which
    the other path's is not (another combine, and drops at cf 0.3); the
    branch counter names the path taken."""
    E, k = 8, 2
    x, wr, w1, w3, w2 = _experts(np.random.default_rng(9), T, 32, 16, E)
    ours, ref = _cfgs(E, k, 0.3)
    L.reset_moe_branches()
    out, _ = L._moe_local(*map(_t, (x, wr, w1, w3, w2)), ours)
    jout, _ = _jit(JL._moe_local)(*map(_j, (x, wr, w1, w3, w2)), ref)
    want = "sorted" if T * k >= E else "gathered"
    assert dict(L.MOE_BRANCHES) == {want: 1}
    _hold_bf16(out, jout)
    other = _jit(JL.moe_gathered_experts if want == "sorted"
                 else JL.moe_sorted_dispatch)(*map(_j, (x, wr, w1, w3, w2)),
                                              ref)[0]
    assert (_np(other) == _np(jout)).mean() < SAME_BITS


def test_moe_block_local():
    x, wr, w1, w3, w2 = _experts(np.random.default_rng(2), 2 * 96, 32, 16, 8)
    x = x.reshape(2, 96, 32)
    ours, ref = _cfgs(8, 2)
    out, aux = L.moe_block(*map(_t, (x, wr, w1, w3, w2)), ours)
    jout, jaux = _jit(JL.moe_block)(*map(_j, (x, wr, w1, w3, w2)), ref)
    assert out.shape == (2, 96, 32)
    _hold_bf16(out, jout)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


# ----------------------------------------------------- the reduced models
def _lm(arch_id):
    ours, ref = get_arch(arch_id, True), j_get_arch(arch_id, True)
    jp = jax.jit(lambda key: j_init_params(key, JM.param_specs(ref.cfg)))(
        jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jp)
    return ours, ref, lm_params_from_jax(host, device="cpu"), jp, host


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return _lm(request.param)


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_the_reference(arch_id, reduced):
    ours, ref = get_arch(arch_id, reduced), j_get_arch(arch_id, reduced)
    assert (ours.arch_id, ours.family, ours.source) == \
        (ref.arch_id, ref.family, ref.source)
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(ref.cfg)
    assert ours.cfg.param_count() == ref.cfg.param_count()
    assert ours.cfg.active_param_count() == ref.cfg.active_param_count()
    specs, jspecs = M.param_specs(ours.cfg), JM.param_specs(ref.cfg)
    assert specs["blocks"].keys() == jspecs["blocks"].keys()
    for name, s in specs["blocks"].items():
        j = jspecs["blocks"][name]
        assert (s.shape, s.axes, s.init, str(s.dtype)[6:]) == \
            (j.shape, j.axes, j.init, str(j.dtype)), name


def test_published_sizes():
    qwen, mixtral = get_arch("qwen2-moe-a2.7b").cfg, \
        get_arch("mixtral-8x22b").cfg
    assert qwen.param_count() == 14_004_619_264
    assert qwen.active_param_count() == 2_378_008_576
    assert mixtral.param_count() == 140_428_744_704
    assert dataclasses.replace(mixtral, n_layers=2).param_count() == \
        5_209_454_592


def test_weights_carry_across(lm):
    ours, _, tp, _, host = lm
    for (k, a), (jk, b) in zip(CKPT._flatten(tp), CKPT._flatten(host)):
        assert k == jk and a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), _np(b))
    assert set(tp["blocks"]) >= {"w_router", "we1", "we3", "we2"}


def test_forward_loss_and_prefill(lm):
    ours, ref, tp, jp, _ = lm
    toks = np.random.default_rng(1).integers(0, 256, (2, 48)) \
        .astype(np.int32)
    L.reset_moe_branches()
    logits, aux, cache = M.forward(tp, ours.cfg, torch.from_numpy(toks),
                                   collect_cache=True)
    assert dict(L.MOE_BRANCHES) == {"sorted": ours.cfg.n_layers}
    jlogits, jaux, jcache = JM.forward(jp, ref.cfg, jnp.asarray(toks),
                                       collect_cache=True)
    _hold_logits(logits, jlogits)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=AUX_TOL)
    for a, b in zip(cache, jcache):
        assert _rel(a.float(), b) <= CACHE_TOL
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    loss = M.loss_fn(tp, ours.cfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    jloss = JM.loss_fn(jp, ref.cfg, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    # the router term is in the loss: the loss minus it is the CE
    ce = M.softmax_xent(logits, torch.from_numpy(batch["labels"]))
    assert loss.item() == pytest.approx(
        ce.item() + ours.cfg.aux_loss_coef * aux.item() / ours.cfg.n_layers,
        rel=1e-6)
    last, kv = M.prefill_step(tp, ours.cfg, torch.from_numpy(toks))
    jlast, jkv = JM.prefill_step(jp, ref.cfg, jnp.asarray(toks))
    _hold_logits(last, jlast)
    # the last row alone: the same sums, a GEMM of another shape
    torch.testing.assert_close(last, logits[:, -1:], rtol=1e-5, atol=1e-6)


def _ring(cfg, kv, seq_len):
    """The reference's prefill cache in the ring of ``cache_len`` slots,
    built with numpy as ``cache_from_prefill`` documents it."""
    k, v = (np.asarray(t) for t in kv)
    S = k.shape[2]
    Sc = JM.cache_len(cfg, seq_len)
    pos = np.arange(max(S - Sc, 0), S)
    ck = np.zeros(k.shape[:2] + (Sc,) + k.shape[3:], k.dtype)
    cv = np.zeros_like(ck)
    ck[:, :, pos % Sc], cv[:, :, pos % Sc] = k[:, :, pos], v[:, :, pos]
    slot_pos = np.full(Sc, -1, np.int32)
    slot_pos[pos % Sc] = pos
    return {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
            "slot_pos": jnp.asarray(slot_pos)}


def test_decode_past_the_window(lm):
    """Prefill 40 tokens (past mixtral's 32-token reduced window), fill
    the ring cache, then 3 decode steps in both packages on the same
    tokens (one token: T·k < E, the gathered path); and the port's
    prefill + one decode step against its own forward over 41 tokens,
    with no capacity drops (C = T): the sorted dispatch drops the latest
    tokens of a full expert, so with drops the forward's last position
    is not the decode step's."""
    ours, ref, tp, jp, _ = lm
    cfg = ours.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (1, 40)).astype(np.int32)
    nxt = rng.integers(0, 256, (1, 3)).astype(np.int32)
    _, kv = M.prefill_step(tp, cfg, torch.from_numpy(toks))
    _, jkv = JM.prefill_step(jp, ref.cfg, jnp.asarray(toks))
    seq_len = 40 + 3
    cache = M.cache_from_prefill(cfg, kv, seq_len)
    jcache = _ring(ref.cfg, jkv, seq_len)
    Sc = M.cache_len(cfg, seq_len)
    assert cache["k"].shape[2] == Sc == (32 if cfg.window else seq_len)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    L.reset_moe_branches()
    for i in range(3):
        t = nxt[:, i:i + 1]
        logits, cache = M.decode_step(tp, cfg, cache, torch.from_numpy(t),
                                      40 + i)
        jlogits, jcache = JM.decode_step(jp, ref.cfg, jcache,
                                         jnp.asarray(t), 40 + i)
        _hold_logits(logits, jlogits)
        assert _rel(cache["k"].float(), jcache["k"]) <= CACHE_TOL
    assert dict(L.MOE_BRANCHES) == {"gathered": 3 * cfg.n_layers}
    whole = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    _, kv = M.prefill_step(tp, whole, torch.from_numpy(toks))
    step, _ = M.decode_step(tp, whole, M.cache_from_prefill(whole, kv, 41),
                            torch.from_numpy(nxt[:, :1]), 40)
    full = M.forward(tp, whole, torch.cat([torch.from_numpy(toks),
                                           torch.from_numpy(nxt[:, :1])],
                                          1))[0]
    _hold_logits(step, full[:, -1:])


def _train_step_held(ours, ref, tp, jp, loss_tol, norm_tol, moment_tol):
    """One ``make_train_fn`` step in both packages on the same batch: the
    loss (router term included) within ``loss_tol``, the grad norm within
    ``norm_tol`` (relative), the learning rate exactly, the updated params
    within 2·lr + one bf16 ulp of a bf16 leaf (Adam's first step moves a
    weight by about ±lr whatever its gradient, so this pins only the
    step's size), and AdamW's moments ``mu`` and ``nu`` leaf by leaf
    within ``moment_tol`` of the leaf's max |ref| element by element and
    in norm: these pin the gradient, the router's and the shared expert's
    gate's included."""
    toks = np.random.default_rng(4).integers(0, 256, (2, 32)) \
        .astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jnew, jm = jax.jit(JS.make_train_fn(ref, 1))(
        {"params": jp, "opt": JO.init_state(jp)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = S.make_train_fn(ours, 1)(
        {"params": tp, "opt": OPT.init_state(tp)},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=loss_tol)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=norm_tol)
    assert m["lr"].item() == float(jm["lr"])
    lr = float(jm["lr"])
    for (k, a), b in zip(CKPT._flatten(new["params"]),
                         jax.tree.leaves(jnew["params"])):
        ulp = np.abs(_np(b)) * 2.0 ** -7 if a.dtype == torch.bfloat16 \
            else 0.0
        a, b = _np(a.float()), _np(b)
        assert (np.abs(a - b) <= 2 * lr + 1e-7 + ulp).all(), k
    gates = {"blocks/w_router"} | (
        {"blocks/w_shared_gate"} if ours.cfg.d_ff_shared else set())
    for name in ("mu", "nu"):
        held = set()
        for (k, a), b in zip(CKPT._flatten(new["opt"][name]),
                             jax.tree.leaves(jnew["opt"][name])):
            assert a.dtype == torch.float32 and a.shape == b.shape, k
            a, b = a.numpy(), _np(b)
            scale = np.abs(b).max()
            assert scale > 0, (name, k)
            assert np.abs(a - b).max() <= moment_tol * scale, (name, k)
            assert np.linalg.norm(a - b) <= \
                moment_tol * np.linalg.norm(b), (name, k)
            held.add(k)
        assert gates <= held, (name, held)


def test_train_step_matches_reference(lm):
    """The reduced model's bf16 weights and activations: loss within rtol
    1e-3, grad norm within 5e-2, the moments within 1e-1 (measured: loss
    1.8e-5, norm 1.3e-2, mu 4.6e-2 and nu 7.8e-2 of the max, the router
    3.5e-2 and 2.6e-2, the shared gate 3.0e-2 and 4.2e-2: both packages
    round each layer's activations to bf16, in different places, so the
    gradients part at bf16's rounding, as ``tests/test_torch_train.py``'s
    bf16 step)."""
    ours, ref, tp, jp, _ = lm
    _train_step_held(ours, ref, tp, jp, 1e-3, 5e-2, 1e-1)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_step_f32_matches_reference(arch_id):
    """The reduced model in f32 (weights and activations): loss within
    rtol 1e-5, grad norm within 1e-4, the moments within 5e-3 (measured:
    loss 5e-7, norm 8.5e-6, moments 1.3e-5 (qwen2-moe) and 1.5e-3
    (mixtral) of the max, the router 4e-6 and 2.1e-4: the attention
    rounds q, k, v and the probabilities to bf16 in both packages
    whatever the activations' dtype, and mixtral's window attention
    rounds in other places than the reference's)."""
    ours, ref = get_arch(arch_id, True), j_get_arch(arch_id, True)
    ours = dataclasses.replace(ours, cfg=dataclasses.replace(
        ours.cfg, dtype="float32"))
    ref = dataclasses.replace(ref, cfg=dataclasses.replace(
        ref.cfg, dtype="float32"))
    jp = jax.jit(lambda key: j_init_params(key, JM.param_specs(ref.cfg)))(
        jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    _train_step_held(ours, ref, tp, jp, 1e-5, 1e-4, 5e-3)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_build_cell_equals_reference(arch_id):
    """Every cell of the full config: the step's name, kind, donation and
    the arguments' shapes and dtypes the reference's (meta tensors); and
    ``materialize`` of the reduced config's prefill and decode cases,
    shaped as the reference's cells."""
    small, jsmall = get_arch(arch_id, True), j_get_arch(arch_id, True)
    for kind in ("prefill", "decode"):
        ours = S.materialize(torch.Generator().manual_seed(0), small,
                             ShapeCase("c", kind, batch=2, seq_len=40),
                             "cpu")
        ref = JS.build_cell(jsmall, JShapeCase("c", kind, batch=2,
                                               seq_len=40)).args
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            # the decode position is a Python int in the port
            got = [(k, tuple(x.shape), str(x.dtype)[6:])
                   for k, x in CKPT._flatten(a) if k != "pos"]
            want = [(k, tuple(x.shape), str(x.dtype))
                    for k, x in CKPT._flatten(b) if k != "pos"]
            assert got == want, kind
    arch, jarch = get_arch(arch_id), j_get_arch(arch_id)
    for case in arch.shapes:
        if arch.shapes[case].skip:
            continue
        cell = S.build_cell(arch, arch.shapes[case])
        jcell = JS.build_cell(jarch, jarch.shapes[case])
        assert (cell.name, cell.kind, cell.donate) == \
            (jcell.name, jcell.kind, jcell.donate)
        for a, b in zip(cell.args, jcell.args):
            got = [(k, tuple(x.shape), str(x.dtype)[6:])
                   for k, x in CKPT._flatten(a)]
            want = [(k, tuple(x.shape), str(x.dtype))
                    for k, x in CKPT._flatten(b)]
            assert got == want, case


# ------------------------------------------------ the expert-parallel branch
_CHILD = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from repro.models import layers as L
from repro.distributed.context import shard_ctx
from repro.distributed.sharding import SINGLE_POD_RULES
a = np.load(sys.argv[1])
args = [jnp.asarray(a[k], jnp.bfloat16) for k in ("x", "wr", "w1", "w3", "w2")]
moe = L.MoEConfig(int(a["E"]), int(a["k"]))
out = {}
for shape in json.loads(sys.argv[3]):
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         devices=jax.devices()[:n])
    with shard_ctx(mesh, SINGLE_POD_RULES):
        o, aux = jax.jit(lambda *a: L.moe_block(*a, moe))(*args)
    out[f"out_{shape[0]}x{shape[1]}"] = np.asarray(o, np.float32)
    out[f"aux_{shape[0]}x{shape[1]}"] = np.float32(aux)
np.savez(sys.argv[2], **out)
"""
MESHES = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def ep_case(tmp_path_factory):
    """Reduced qwen's experts (E=8, top-2, d_ff 32) on 2 x 2048 tokens,
    and the reference's sharded branch on forced 4-device meshes, run in
    a child process (the device count is fixed at jax's import)."""
    rng = np.random.default_rng(7)
    x, wr, w1, w3, w2 = _experts(rng, 2 * 2048, 64, 32, 8)
    x = x.reshape(2, 2048, 64)
    d = tmp_path_factory.mktemp("ep")
    np.savez(d / "in.npz", x=x, wr=wr, w1=w1, w3=w3, w2=w2, E=8, k=2)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, str(d / "in.npz"), str(d / "out.npz"),
         json.dumps(MESHES)], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return (x, wr, w1, w3, w2), dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("shape", MESHES)
def test_expert_parallel_branch(ep_case, shape, monkeypatch):
    """``moe_block`` under a shard_ctx on logical CPU meshes of
    (data, model) = ``shape``: the expert-parallel branch (one shard a
    mesh position), its routing exactly the local branch's, its output
    within SHARD_TOL of the local branch on each batch shard's tokens (a
    shard's capacity counts its own tokens) and of the reference's sharded
    branch, its aux the reference's, the batch shards' mean."""
    (x, wr, w1, w3, w2), ref = ep_case
    moe = L.MoEConfig(8, 2)
    args = [_t(a) for a in (x, wr, w1, w3, w2)]
    outs = [L.moe_block(xb, *args[1:], moe) for xb in args[0].chunk(shape[0])]
    local = torch.cat([o for o, _ in outs])
    local_aux = sum(a.item() for _, a in outs) / shape[0]
    routed = []
    topk = L.router_topk

    def spy(*a):
        out = topk(*a)
        routed.append(out[0])
        return out

    monkeypatch.setattr(L, "router_topk", spy)
    n = shape[0] * shape[1]
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[torch.device("cpu", i) for i in range(n)])
    L.reset_moe_branches()
    with shard_ctx(mesh, SH.SINGLE_POD_RULES):
        out, aux = L.moe_block(*args, moe)
    assert dict(L.MOE_BRANCHES) == {"expert_parallel": 1, "sorted": n}
    # each shard routes its batch slice: the local branch's indices
    want = topk(args[0].reshape(-1, 64), args[1], moe)[0] \
        .reshape(shape[0], -1, 2)
    assert len(routed) == n
    for i, r in enumerate(routed):       # row-major: data, then model
        assert torch.equal(r, want[i // shape[1]])
    assert out.shape == local.shape and out.dtype == torch.bfloat16
    key = f"{shape[0]}x{shape[1]}"
    assert _rel(out.float(), local.float()) <= SHARD_TOL
    assert _rel(out.float(), ref[f"out_{key}"]) <= SHARD_TOL
    np.testing.assert_allclose(aux.item(), float(ref[f"aux_{key}"]),
                               rtol=1e-6)
    assert aux.item() == pytest.approx(local_aux, rel=1e-6)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_expert_parallel_tolerance_sees_a_lost_partial(ep_case, shape,
                                                        monkeypatch):
    """SHARD_TOL lies between the branch's rounding and a fault: with the
    last tensor shard's partial left out of the sum (the reduction's
    other inputs as they are) the output is off by far more than
    SHARD_TOL (measured 0.94 and 0.87 of max|out| at 1x2 and 1x4), while
    the whole sum is within it (measured 0.0085 at both)."""
    (x, wr, w1, w3, w2), _ = ep_case
    moe = L.MoEConfig(8, 2)
    args = [_t(a) for a in (x, wr, w1, w3, w2)]
    local, _ = L.moe_block(*args, moe)
    n = shape[0] * shape[1]
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[torch.device("cpu", i) for i in range(n)])
    with shard_ctx(mesh, SH.SINGLE_POD_RULES):
        whole, _ = L.moe_block(*args, moe)
    reduce = SMC._reduce
    monkeypatch.setattr(SMC, "_reduce", lambda op, xs: reduce(
        op, xs[:-1] if op == "sum" else xs))
    with shard_ctx(mesh, SH.SINGLE_POD_RULES):
        lost, _ = L.moe_block(*args, moe)
    assert _rel(whole.float(), local.float()) <= SHARD_TOL
    assert _rel(lost.float(), local.float()) > 8 * SHARD_TOL


def test_expert_parallel_condition():
    """The reference's condition: batch axes, a tensor axis > 1, B over
    the batch axes, d_ff over the tensor axis, B·S >= 4096; otherwise the
    local branch."""
    x, wr, w1, w3, w2 = _experts(np.random.default_rng(8), 4, 16, 12, 4)
    ws = [_t(a) for a in (wr, w1, w3, w2)]
    moe = L.MoEConfig(4, 2)
    devs = [torch.device("cpu", i) for i in range(8)]
    cases = [((2, 2), "baseline", 2, 2048, True),
             ((2, 2), "baseline", 2, 2047, False),     # B·S < 4096
             ((2, 2), "baseline", 3, 2048, False),     # B over data
             ((4, 1), "baseline", 4, 1024, False),     # tensor axis 1
             ((1, 8), "baseline", 2, 2048, False),     # d_ff 12 over 8
             ((1, 4), "baseline", 3, 2048, True),
             ((2, 2), "ep", 2, 2048, False)]           # no tensor axis
    for shape, variant, B, S_, sharded in cases:
        xs = _t(np.resize(x, (B, S_, 16)))
        mesh = make_mesh(shape, ("data", "model"),
                         devices=devs[:shape[0] * shape[1]])
        L.reset_moe_branches()
        with shard_ctx(mesh, SH.make_axis_rules(False, variant)):
            out, _ = L.moe_block(xs, *ws, moe)
        assert ("expert_parallel" in L.MOE_BRANCHES) == sharded, \
            (shape, variant, B, S_)
        assert out.shape == (B, S_, 16)


# ------------------------------------------------------------ placement
def test_shard_map_compat_parameter_specs_and_reductions():
    """Operands split over different axes and along later dimensions,
    outputs summed over one axis and averaged over another: equal to the
    unsharded computation (integer values, exact sums); a parameter's
    slice a view where it is on its shard's device, else copied there
    once and kept with the tensor (a stacked weight's layers on the
    stack) until it changes in place."""
    devs = [torch.device("cpu", i) for i in range(4)]
    mesh = make_mesh((2, 2), ("data", "model"), devices=devs)
    x = torch.arange(4 * 3 * 6, dtype=torch.float32).reshape(4, 3, 6) % 7
    w = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8) % 5
    v = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6) % 3
    seen = []

    def body(xb, wb, vb):
        seen.append(wb)
        y = (xb @ wb) @ vb                    # partial over the model axis
        return y, xb.sum()

    run = SMC.shard_map_compat(
        body, mesh, (SH.P("data"), SH.P(None, "model"), SH.P("model", None)),
        (SH.P("data"), SH.P()), reduce=(("sum", "model"), ("mean", "data")))
    y, s = run(x, w, v)
    torch.testing.assert_close(y, (x @ w) @ v, rtol=0, atol=0)
    assert s.item() == x.sum().item() / 2
    assert [tuple(t.shape) for t in seen] == [(6, 4)] * 4
    # a stacked weight's layers (views) take the copies kept on the stack
    stack = torch.stack([w, w + 1])
    seen.clear()
    for i in (0, 1, 0, 1):
        run(x, stack[i], v)
    assert all(a is b for a, b in zip(seen[8:], seen[:8]))
    assert not any(a is b for a, b in zip(seen[4:8], seen[:4]))
    assert len(stack._mesh_copies) == 8        # 2 layers x 4 devices
    stack.add_(0)                              # changed in place: copied anew
    run(x, stack[0], v)
    assert not any(a is b for a, b in zip(seen[16:], seen[:4]))
    # shards on the tensor's own device take views
    same = make_mesh((2, 2), ("data", "model"),
                     devices=[torch.device("cpu")] * 4)
    seen.clear()
    SMC.shard_map_compat(
        body, same, (SH.P("data"), SH.P(None, "model"), SH.P("model", None)),
        (SH.P("data"), SH.P()), reduce=(("sum", "model"), ("mean", "data")))(
            x, w, v)
    assert all(t._base is w for t in seen)
    # a split of two dimensions gathers back in row-major block order
    m = torch.arange(4 * 6.0).reshape(4, 6)
    two = SMC.shard_map_compat(lambda t: t * 2, mesh,
                               (SH.P("model", "data"),), SH.P("model", "data"))
    torch.testing.assert_close(two(m), m * 2, rtol=0, atol=0)
    with pytest.raises(ValueError, match="'sum' or 'mean'"):
        SMC.shard_map_compat(body, mesh, (SH.P("data"), SH.P(), SH.P()),
                             (SH.P("data"), SH.P()),
                             reduce=(("max", "data"), None))(x, w, v)


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (3, 2)])
def test_named_and_tree_shardings_equal_the_reference(arch_id, shape):
    """``tree_shardings`` over the full config's specs: every spec equal
    to the reference's on a mesh of the same axis sizes (non-dividing
    dimensions replicated), under every named rule table."""
    cfg, jcfg = get_arch(arch_id).cfg, j_get_arch(arch_id).cfg
    devs = [torch.device("cpu", i) for i in range(shape[0] * shape[1])]
    mesh = make_mesh(shape, ("data", "model"), devices=devs)
    jmesh = AbstractMesh(shape, ("data", "model"))
    for variant in ("baseline", "ep", "kvrep", "dp"):
        rules = SH.make_axis_rules(False, variant)
        jrules = JSH.make_axis_rules(False, variant)
        ours = SH.tree_shardings(mesh, M.param_specs(cfg), rules)
        ref = JSH.tree_shardings(jmesh, JM.param_specs(jcfg), jrules)
        got = [(k, a.mesh is mesh, repr(tuple(a.spec)))
               for k, a in CKPT._flatten(ours)]
        want = [(k, True, r) for k, r in CKPT._flatten(
            jax.tree.map(lambda s: repr(tuple(s.spec)), ref))]
        assert got == want, variant
    one = SH.named_sharding(mesh, ("fsdp", "tensor"), SH.SINGLE_POD_RULES,
                            (6, 9))
    jone = JSH.named_sharding(jmesh, ("fsdp", "tensor"),
                              JSH.SINGLE_POD_RULES, (6, 9))
    assert tuple(one.spec) == tuple(jone.spec)


def test_reshard_params_and_restore_onto_shardings(tmp_path):
    """Reduced mixtral's params laid out on a logical (2, 2) mesh: every
    shard is its slice (the reference's shard shape) on its device, and
    ``full()`` gives the params bit for bit; the same through
    ``restore(shardings=)`` of a checkpoint the reference wrote, against
    the reference's own restore onto its one-device mesh."""
    arch, jarch = get_arch("mixtral_8x22b", True), \
        j_get_arch("mixtral_8x22b", True)
    cfg = dataclasses.replace(arch.cfg, dtype="float32")
    jcfg = dataclasses.replace(jarch.cfg, dtype="float32")
    host = jax.tree.map(np.asarray, j_init_params(
        jax.random.PRNGKey(1), JM.param_specs(jcfg)))
    params = PM.tree_map(lambda a: torch.from_numpy(np.array(a)), host)
    devs = [torch.device("cpu", i) for i in range(4)]
    mesh = make_mesh((2, 2), ("data", "model"), devices=devs)
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    specs = M.param_specs(cfg)
    placed = EL.reshard_params(params, specs, mesh)
    ref_sh = JSH.tree_shardings(jmesh, JM.param_specs(jcfg),
                                JSH.make_axis_rules(False))

    def check(tree):
        flat_ref = dict(CKPT._flatten(jax.tree.map(
            lambda s: s, ref_sh, is_leaf=lambda s: hasattr(s, "spec"))))
        for k, p in CKPT._flatten(tree):
            assert isinstance(p, Placed), k
            full = dict(CKPT._flatten(params))[k]
            assert torch.equal(p.full(), full), k
            shard_shape = flat_ref[k].shard_shape(tuple(full.shape))
            for coords in np.ndindex(2, 2):
                assert tuple(p.shards[coords].shape) == shard_shape, k
                assert torch.equal(p.shards[coords], full[p.index(coords)])
                assert p.shards[coords].device.type == \
                    mesh.devices[coords].type

    check(placed)
    assert placed["blocks"]["we1"].sharding.spec == SH.P(None, None, "data",
                                                         "model")
    JCKPT.save(str(tmp_path), 3, host)
    shardings = SH.tree_shardings(mesh, specs, SH.make_axis_rules(False))
    back = CKPT.restore(str(tmp_path), 3, params, shardings=shardings)
    check(back)
    jmesh1 = jax.make_mesh((1, 1), ("data", "model"))
    jback = JCKPT.restore(str(tmp_path), 3, host, shardings=JSH.tree_shardings(
        jmesh1, JM.param_specs(jcfg), JSH.make_axis_rules(False)))
    for (k, a), b in zip(CKPT._flatten(back), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a.full().numpy(), np.asarray(b))
    jres = JEL.reshard_params(host, JM.param_specs(jcfg), jmesh1)
    for (k, a), b in zip(CKPT._flatten(placed), jax.tree.leaves(jres)):
        np.testing.assert_array_equal(a.full().numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="does not split 2 ways"):
        device_put(torch.zeros(3, 4), NamedSharding(mesh, SH.P("data")))
