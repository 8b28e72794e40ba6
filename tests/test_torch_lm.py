"""The port's decoder-LM serving path on the CPU against the JAX package:
configs, parameter counts, the dense layers, and reduced llama3.2-1B and
chatglm3-6B (forward with both attention paths, prefill, decode over bf16
and int8 caches), with the reference's weights carried across by
``lm_params_from_jax`` and the same numpy tokens.

Tolerances.  Layer functions take the same bf16 inputs in both packages
and must agree to f32 rounding (their outputs are bf16, or f32 sums taken
in another order).  With f32 activations (``dtype="float32"``) the
whole models agree to 5e-3 of the largest logit on the plain attention
path, forward and decode (measured: at most 2.0e-3; the attention still
rounds q, k, v and p to bf16 in both packages, which is where the two
part).  With the
published bf16 activations every value is rounded to bf16, so a one-ulp
difference in a layer-0 projection (the two BLAS libraries sum in
different orders) spreads through the residual stream: logits are held
to 0.1 of their largest magnitude (measured over these cases: at most
0.050; the reference's own pallas-vs-xla gap on these models is up to
0.023), every greedy pick must agree or be a near tie, and caches to 0.02
of their largest magnitude (measured: at most 0.009)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer_lm as JM
from repro.models.params import init_params as j_init_params
from repro.models.params import param_bytes as j_param_bytes
from repro_torch import device as port_device
from repro_torch.configs import ShapeCase, get_arch
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import params as PM
from repro_torch.models import transformer_lm as M
from repro_torch.models.weights import lm_params_from_jax

LOGIT_TOL = 0.1
CACHE_TOL = 0.02
F32_TOL = 5e-3
ARCHS = ["llama3_2_1b", "chatglm3_6b"]


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _rel(ours, ref) -> float:
    ours, ref = _np(ours), _np(ref)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _hold_logits(ours, ref):
    ours, ref = _np(ours), _np(ref)
    assert np.isfinite(ours).all()
    assert _rel(ours, ref) <= LOGIT_TOL, _rel(ours, ref)
    pick, pick_ref = ours.argmax(-1), ref.argmax(-1)
    gap = np.abs(np.take_along_axis(ref, pick_ref[..., None], -1)
                 - np.take_along_axis(ref, pick[..., None], -1)).max()
    assert gap <= np.abs(ours - ref).max(), gap


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_the_reference(arch_id, reduced):
    ours, ref = get_arch(arch_id, reduced), j_get_arch(arch_id, reduced)
    assert (ours.arch_id, ours.family, ours.source) == \
        (ref.arch_id, ref.family, ref.source)
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(ref.cfg)
    assert {k: dataclasses.asdict(v) for k, v in ours.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.shapes.items()}
    # counted from the specs: nothing is allocated
    specs, jspecs = M.param_specs(ours.cfg), JM.param_specs(ref.cfg)
    assert ours.cfg.param_count() == ref.cfg.param_count()
    assert PM.param_bytes(specs) == j_param_bytes(jspecs)
    flat = {f"{k}.{n}": s for k, v in specs.items()
            for n, s in (v.items() if isinstance(v, dict) else [("", v)])}
    jflat = {f"{k}.{n}": s for k, v in jspecs.items()
             for n, s in (v.items() if isinstance(v, dict) else [("", v)])}
    assert flat.keys() == jflat.keys()
    for name, s in flat.items():
        j = jflat[name]
        assert (s.shape, s.axes, s.init, s.scale) == \
            (j.shape, j.axes, j.init, j.scale), name


def test_llama3_2_1b_parameter_count():
    assert get_arch("llama3.2-1b").cfg.param_count() == 1_235_814_400


def test_unported_archs_and_moe_raise():
    """The vision and diffusion ids resolve since their slice (tests/
    test_torch_zoo_configs.py holds them) and an unknown id raises; the
    MoE LMs build since theirs (tests/test_torch_moe.py holds them),
    and their train case raises from ``make_infer_fn`` as a dense one's."""
    assert get_arch("resnet_50").cfg.param_count() == 25_557_032
    assert get_arch("dit-xl2").cfg.param_count() == 679_406_992
    with pytest.raises(ValueError):
        get_arch("gpt5")
    assert get_arch("qwen2-moe-a2.7b").cfg.moe.n_experts == 60
    moe = j_get_arch("mixtral_8x22b", reduced=True).cfg.moe
    cfg = M.LMConfig(name="x", n_layers=1, d_model=8, n_heads=2,
                     n_kv_heads=1, d_ff=8, vocab=8,
                     moe=L.MoEConfig(**dataclasses.asdict(moe)))
    assert cfg.active_param_count() == cfg.param_count() - 2 * 3 * 8 * 8
    for arch_id in ("llama3_2_1b", "mixtral_8x22b"):
        with pytest.raises(NotImplementedError):
            S.make_infer_fn(get_arch(arch_id, reduced=True),
                            ShapeCase("t", "train", batch=1, seq_len=8))


def test_entry_points_default_to_cuda():
    arch = get_arch("llama3_2_1b", reduced=True)
    case = ShapeCase("p", "prefill", batch=1, seq_len=8)
    for call in (lambda: S.materialize(torch.Generator(), arch, case),
                 lambda: lm_params_from_jax({"final_ln": np.ones(4)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    port_device.resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        is False


def test_init_params_rules():
    specs = {"a": PM.spec((64, 512), (None, None), init="fan_in"),
             "b": {"c": PM.spec((256, 256), (None, None)),
                   "z": PM.spec((3,), (None,), init="zeros"),
                   "o": PM.spec((3,), (None,), init="ones",
                                dtype=torch.float32)}}
    p = PM.init_params(torch.Generator().manual_seed(0), specs, "cpu")
    assert p["a"].dtype == torch.bfloat16 and p["b"]["o"].dtype == \
        torch.float32
    # fan_in: the second-last dimension
    assert abs(float(p["a"].float().std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["b"]["c"].float().std()) - 0.02) < 0.001
    assert not p["b"]["z"].any() and bool((p["b"]["o"] == 1).all())
    assert PM.param_count(specs) == 64 * 512 + 256 * 256 + 6
    assert PM.param_bytes(specs) == 2 * (64 * 512 + 256 * 256 + 3) + 12


# ------------------------------------------------------------- layers
@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_rms_norm(rng):
    x = rng.normal(0, 3, (2, 5, 64))
    w = rng.normal(1, 0.1, (64,))
    ref = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                      1e-5)
    ours = L.rms_norm(_t(x), _t(w), 1e-5)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ours.float()), _np(ref))


@pytest.mark.parametrize("fraction,theta", [(1.0, 500000.0), (0.5, 10000.0)])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope(rng, fraction, theta, batched_positions):
    np.testing.assert_array_equal(
        L.rope_freqs(64, fraction, theta).numpy(),
        _np(JL.rope_freqs(64, fraction, theta)))
    x = rng.normal(0, 2, (2, 9, 4, 64))
    pos = rng.integers(0, 5000, (2, 9) if batched_positions else (9,))
    ref = JL.apply_rope(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(pos, jnp.int32), fraction=fraction,
                        theta=theta)
    ours = L.apply_rope(_t(x), torch.from_numpy(pos.astype(np.int32)),
                        fraction=fraction, theta=theta)
    assert ours.dtype == torch.bfloat16
    # sin/cos of large angles differ in the last f32 bits between the two
    # libraries; a rotated value may round to the neighbouring bf16
    np.testing.assert_allclose(_np(ours.float()), _np(ref), rtol=2 ** -7,
                               atol=2 ** -7)
    # the unrotated half is passed through untouched
    rot = int(64 * fraction)
    np.testing.assert_array_equal(_np(ours[..., rot:].float()),
                                  _np(ref[..., rot:]))


def _qkv(rng, B, Sq, Sk, H, Hk, D):
    return [rng.normal(0, 1, s) for s in
            ((B, Sq, H, D), (B, Sk, Hk, D), (B, Sk, Hk, D))]


@pytest.mark.parametrize("causal,q_offset,with_positions",
                         [(True, 0, False), (False, 0, False),
                          (True, 16, True)])
def test_chunked_attention(rng, causal, q_offset, with_positions):
    q, k, v = _qkv(rng, 2, 16, 64, 4, 2, 16)
    kvp = None
    if with_positions:      # a ring: some slots unwritten
        kvp = rng.permutation(64).astype(np.int32) - 8
    kw = dict(causal=causal, q_offset=q_offset, chunk=16)
    ref = JL.chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        kv_positions=None if kvp is None else jnp.asarray(kvp), **kw)
    ours = L.chunked_attention(
        *(_t(a) for a in (q, k, v)),
        kv_positions=None if kvp is None else torch.from_numpy(kvp), **kw)
    assert ours.dtype == torch.bfloat16 and ours.shape == (2, 16, 4, 16)
    np.testing.assert_allclose(_np(ours.float()), _np(ref), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("window,q_offset", [(8, 0), (24, 0), (8, 32)])
def test_swa_attention(rng, window, q_offset):
    q, k, v = _qkv(rng, 1, 64, 64 + q_offset, 4, 2, 16)
    kw = dict(window=window, q_offset=q_offset, q_block=16)
    ref = JL.swa_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           **kw)
    ours = L.swa_attention(*(_t(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(ours.float()), _np(ref), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention(rng, window):
    q, k, v = _qkv(rng, 2, 1, 12, 8, 2, 16)
    slots = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, -1, -1, 11], np.int32)
    ref = JL.decode_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        cache_positions=jnp.asarray(slots), pos=jnp.asarray(8, jnp.int32),
        window=window)
    ours = L.decode_attention(*(_t(a) for a in (q, k, v)),
                              cache_positions=torch.from_numpy(slots), pos=8,
                              window=window)
    np.testing.assert_allclose(_np(ours.float()), _np(ref), rtol=2 ** -7,
                               atol=1e-6)


def test_swiglu(rng):
    x, w1, w3, w2 = (rng.normal(0, s, shape) for s, shape in
                     ((1, (2, 8, 64)), (0.2, (64, 96)), (0.2, (64, 96)),
                      (0.2, (96, 64))))
    ref = JL.swiglu(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w1, w3, w2)))
    ours = L.swiglu(*(_t(a) for a in (x, w1, w3, w2)))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ours.float()), _np(ref), rtol=2 ** -7,
                               atol=1e-6)


def test_quantize_dequantize_kv(rng):
    x = rng.normal(0, 2, (2, 1, 4, 16))
    x[1, 0, 3] = 0.0                       # an all-zero row: the 1e-6 floor
    jq, jsc = JM._quantize_kv(jnp.asarray(x, jnp.bfloat16))
    q, sc = M._quantize_kv(_t(x))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        _np(M._dequantize_kv(q, sc).float()),
        _np(JM._dequantize_kv(jq, jsc)))


# ------------------------------------------------------ reduced models
def _variant(arch_id, variant):
    """The same config in both packages: as built, with a 32-token window,
    or with q/k/v biases."""
    ours, ref = get_arch(arch_id, True).cfg, j_get_arch(arch_id, True).cfg
    change = {"base": {}, "window": dict(window=32),
              "bias": dict(qkv_bias=True)}[variant]
    return (dataclasses.replace(ours, **change),
            dataclasses.replace(ref, **change))


def _weights(jcfg, seed=0):
    jp = j_init_params(jax.random.PRNGKey(seed), JM.param_specs(jcfg))
    if jcfg.qkv_bias:       # nonzero biases, so the bias path is checked
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            jp["blocks"][name] = jnp.asarray(
                rng.normal(0, 0.5, jp["blocks"][name].shape), jnp.bfloat16)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                  device="cpu")


VARIANTS = [("llama3_2_1b", "base"), ("chatglm3_6b", "base"),
            ("llama3_2_1b", "window"), ("llama3_2_1b", "bias")]


def test_lm_params_from_jax_keeps_layouts_and_values():
    _, jcfg = _variant("llama3_2_1b", "bias")
    jp, tp = _weights(jcfg)
    assert tp["blocks"]["wq"].shape == (2, 64, 4, 16)
    assert tp["blocks"]["wo"].shape == (2, 4, 16, 64)
    assert tp["embed"].shape == (256, 64)
    for name in ("wq", "wo", "bk", "ln1"):
        t = tp["blocks"][name]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      _np(jp["blocks"][name]))


@pytest.mark.parametrize("arch_id,variant", VARIANTS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_prefill_match(arch_id, variant, impl):
    cfg, jcfg = _variant(arch_id, variant)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)) \
        .astype(np.int32)
    jl, _, (jk, jv) = JM.forward(jp, jcfg, jnp.asarray(toks),
                                 collect_cache=True)
    logits, aux, (k, v) = M.forward(tp, cfg, torch.from_numpy(toks),
                                    collect_cache=True)
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 256)
    assert aux == 0.0 and k.shape == (2, 2, 64, 2, 16)
    _hold_logits(logits.numpy(), jl)
    assert _rel(k.float(), jk) <= CACHE_TOL
    assert _rel(v.float(), jv) <= CACHE_TOL
    # layer 0's k and v come before any attention: the same up to the
    # projections' rounding
    np.testing.assert_allclose(_np(k[0].float()), _np(jk[0]), rtol=2 ** -7,
                               atol=1e-6)

    last, (pk, pv) = M.prefill_step(tp, cfg, torch.from_numpy(toks))
    assert last.shape == (2, 1, 256)
    torch.testing.assert_close(last, logits[:, -1:], rtol=0, atol=1e-5)
    assert torch.equal(pk, k) and torch.equal(pv, v)


@pytest.mark.parametrize("arch_id,variant", VARIANTS)
def test_f32_activations_match_tightly(arch_id, variant):
    """The same models with f32 activations and weights, on the plain
    attention path: no bf16 rounding of the residual stream, so the two
    packages' algorithms must agree closely, forward and decode."""
    cfg, jcfg = (dataclasses.replace(c, dtype="float32")
                 for c in _variant(arch_id, variant))
    jp = j_init_params(jax.random.PRNGKey(0), JM.param_specs(jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)) \
        .astype(np.int32)
    jl, _, _ = JM.forward(jp, jcfg, jnp.asarray(toks))
    logits, _, _ = M.forward(tp, cfg, torch.from_numpy(toks))
    assert _rel(logits, jl) <= F32_TOL
    jcache = j_init_params(jax.random.PRNGKey(0),
                           JM.init_cache_specs(jcfg, 2, 8))
    jcache["slot_pos"] = jnp.full_like(jcache["slot_pos"], -1)
    cache = PM.init_params(None, M.init_cache_specs(cfg, 2, 8), "cpu")
    cache["slot_pos"].fill_(-1)
    assert cache["k"].dtype == torch.float32
    for i in range(10):     # past 8 slots: the last one (or the ring) reused
        jl, jcache = JM.decode_step(jp, jcfg, jcache,
                                    jnp.asarray(toks[:, i:i + 1]), i)
        logits, cache = M.decode_step(tp, cfg, cache,
                                      torch.from_numpy(toks[:, i:i + 1]), i)
        assert _rel(logits, jl) <= F32_TOL


def _decode_both(cfg, jcfg, seq_len, n_steps):
    jp, tp = _weights(jcfg, seed=2)
    case = ShapeCase("d", "decode", batch=2, seq_len=seq_len)
    jcache = j_init_params(jax.random.PRNGKey(0),
                           JM.init_cache_specs(jcfg, 2, seq_len))
    jcache["slot_pos"] = jnp.full_like(jcache["slot_pos"], -1)
    cache = PM.init_params(None, M.init_cache_specs(cfg, 2, seq_len), "cpu")
    cache["slot_pos"].fill_(-1)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (n_steps, 2, 1)) \
        .astype(np.int32)
    jstep = jax.jit(JM.decode_step, static_argnums=1)
    step = S.make_infer_fn(dataclasses.replace(get_arch("llama3_2_1b"),
                                               cfg=cfg), case)
    for i in range(n_steps):
        jl, jcache = jstep(jp, jcfg, jcache, jnp.asarray(toks[i]),
                           jnp.asarray(i, jnp.int32))
        logits, cache = step(tp, cache, {"tokens": torch.from_numpy(toks[i]),
                                         "pos": i})
        assert logits.shape == (2, 1, cfg.vocab)
        _hold_logits(logits.numpy(), jl)
    return cache, jcache


@pytest.mark.parametrize("arch_id,variant", VARIANTS)
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_decode_steps_match(arch_id, variant, kv_dtype):
    cfg, jcfg = _variant(arch_id, variant)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype)
    # 12 steps; with the window the cache is a ring of 8 slots
    seq_len = 8 if variant == "window" else 16
    cache, jcache = _decode_both(cfg, jcfg, seq_len, 12)
    assert sorted(cache) == sorted(jcache)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    if kv_dtype == "int8":
        for name in ("k", "v"):
            assert cache[name].dtype == torch.int8
            ours = M._dequantize_kv(cache[name], cache[f"{name}_scale"])
            ref = JM._dequantize_kv(jcache[name], jcache[f"{name}_scale"])
            assert _rel(ours.float(), ref) <= CACHE_TOL
    else:
        for name in ("k", "v"):
            assert _rel(cache[name].float(), jcache[name]) <= CACHE_TOL


def test_prefill_then_decode_matches_forward():
    """The reference's tests/test_models.py consistency check, on the
    port: prefill 16 tokens into a 17-slot cache, decode token 16, and
    compare with the forward over all 17, through the plain kernel path."""
    arch = get_arch("llama3_2_1b", reduced=True)
    cfg = dataclasses.replace(arch.cfg, attention_impl="pallas")
    _, tp = _weights(j_get_arch("llama3_2_1b", True).cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 17)).astype(np.int32))
    full, _, _ = M.forward(tp, cfg, toks)
    _, (k, v) = M.prefill_step(tp, cfg, toks[:, :16])
    cache = PM.init_params(None, M.init_cache_specs(cfg, 1, 17), "cpu")
    cache["k"][:, :, :16] = k
    cache["v"][:, :, :16] = v
    cache["slot_pos"][:] = torch.tensor(list(range(16)) + [-1])
    logits, _ = M.decode_step(tp, cfg, cache, toks[:, 16:], 16)
    _hold_logits(logits[:, 0].numpy(), full[:, -1].numpy())


def test_materialize_matches_reference_structure():
    arch = get_arch("llama3_2_1b", reduced=True)
    jarch = j_get_arch("llama3_2_1b", reduced=True)
    case = ShapeCase("d", "decode", batch=2, seq_len=16)
    params, cache, batch = S.materialize(torch.Generator().manual_seed(0),
                                         arch, case, device="cpu")
    jparams, jcache, jbatch = JS.materialize(jax.random.PRNGKey(0), jarch,
                                             case)
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == \
        {k: ({n: tuple(t.shape) for n, t in v.items()}
             if isinstance(v, dict) else tuple(v.shape))
         for k, v in params.items()}
    for name, t in cache.items():
        assert tuple(t.shape) == jcache[name].shape, name
    assert bool((cache["slot_pos"] == -1).all())
    assert batch["pos"] == int(jbatch["pos"])
    assert batch["tokens"].shape == jbatch["tokens"].shape
    pcase = ShapeCase("p", "prefill", batch=2, seq_len=12)
    _, pbatch = S.materialize(torch.Generator().manual_seed(0), arch, pcase,
                              device="cpu")
    toks = pbatch["tokens"]
    assert toks.shape == (2, 12) and toks.dtype == torch.int32
    assert 0 <= int(toks.min()) and int(toks.max()) < arch.cfg.vocab
