"""The port's diffusion transformer and EDSR-lite on the CPU against the
JAX package: ``timestep_embedding``, ``patchify`` and ``unpatchify``,
reduced DiT-XL/2 ``forward`` (adaLN and final weights made non-zero, a
label past ``n_classes`` and a negative one, which exercise the
reference's clip-mode lookup), ``loss_fn``, ``ddim_step``,
``sample_with_cache`` refreshing every step and every other step, one
train step, and EDSR-lite's forward and loss; the clip-mode lookup the
DiT's labels and the LM's tokens share.  Both packages take the same
seeded numpy parameters (``zoo_params_from_jax``; f32 draws, rounded for
bf16) and latents of 64-px images (8 x 8 x 4, 16 tokens), B = 2.  The
reference's outputs are computed once a dtype, in a module-scoped
fixture.

Tolerances (``_rel``: the largest difference over the reference's
largest magnitude; ``_rel2``: the relative L2 distance).  The embedding,
the patch reshapes and the DDIM update are exact or within f32 rounding
(``F32_TOL``, 1e-5).  DiT in f32 within ``F32_ATTN_TOL`` (2e-3):
``chunked_attention`` takes q, k and v in bf16 in both packages, and an
f32 value a rounding apart flips a bf16 ulp; its gradients within
``GRAD_ATTN_TOL`` (2^-6), because the backward takes bf16 cotangents
through those casts in both packages, each rounded at 2^-9 (measured:
3e-3).  DiT in bf16: within
``BF16_TOL`` (0.05) of the reference's bf16 output, and the loss and
gradients (through AdamW's first moment ``opt["mu"]``, 0.1 times the
clipped gradient at the first step) as near the reference's f32 ones as
``BF16_SLACK`` (3) times the reference's own bf16 distance plus
``BF16_FLOOR`` (2^-7), as in ``tests/test_torch_vision.py``.  EDSR-lite
is f32 and convolutions only: ``F32_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import steps as JS
from repro.models import dit as JD
from repro.models import sr_edsr as JE
from repro.models.params import is_spec
from repro_torch.configs import get_arch
from repro_torch.launch import steps as S
from repro_torch.models import dit as D
from repro_torch.models import layers as L
from repro_torch.models import params as PM
from repro_torch.models import sr_edsr as E
from repro_torch.models import transformer_lm as M
from repro_torch.models.weights import zoo_params_from_jax

F32_TOL = 1e-5
F32_ATTN_TOL = 2e-3
GRAD_ATTN_TOL = 2 ** -6
BF16_TOL = 0.05
BF16_SLACK = 3.0
BF16_FLOOR = 2 ** -7
DTYPES = ("float32", "bfloat16")
B, RES = 2, 64
T_NOW, T_PREV = 500, 480
TIMESTEPS = (999, 749, 499, 249, 0)         # four sampler steps


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    """A numpy array (bf16 ones too) as a CPU tensor of its dtype."""
    return zoo_params_from_jax({"a": a}, "cpu")["a"]


def _rel(ours, ref) -> float:
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert np.isfinite(ours).all()
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _rel2(ours, ref) -> float:
    ours, ref = _np(ours).ravel(), _np(ref).ravel()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref),
                                                  1e-30))


def np_params(specs, seed: int):
    """Numpy parameters for a reference spec tree, every leaf random (the
    adaLN and final weights too, so that the blocks and the output are not
    the zero function): fan-in and normal leaves by their rule, ``ones``
    1 + N(0, 0.1), ``zeros`` N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(specs, is_leaf=is_spec)
    out = []
    for s in leaves:
        z = rng.standard_normal(s.shape).astype(np.float32)
        if s.init == "fan_in":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[0]
            a = z / np.sqrt(fan_in)
        elif s.init == "ones":
            a = 1 + 0.1 * z
        elif s.init == "zeros":
            a = 0.1 * z
        else:
            a = z * s.scale
        out.append(a.astype(s.dtype))
    return jax.tree.unflatten(treedef, out)


def _archs(dtype: str):
    ours, ref = get_arch("dit_xl2", True), j_get_arch("dit_xl2", True)
    return (dataclasses.replace(ours, cfg=dataclasses.replace(
                ours.cfg, dtype=dtype)),
            dataclasses.replace(ref, cfg=dataclasses.replace(
                ref.cfg, dtype=dtype)))


def _inputs():
    rng = np.random.default_rng(11)
    lr = RES // 8
    x = rng.standard_normal((B, lr, lr, 4)).astype(np.float32)
    noise = rng.standard_normal((B, lr, lr, 4)).astype(np.float32)
    return {"x": x, "noise": noise,
            "t": np.array([T_NOW, 120], np.int32),
            "t_prev": np.array([T_PREV, 100], np.int32),
            # 10 classes: 12 clamps to the null row 10, -1 counts from
            # the end (row 10), -13 from the end then clamps (row 0)
            "y": np.array([12, -1], np.int32),
            "y2": np.array([3, -13], np.int32)}


@pytest.fixture(scope="module")
def dit_ref():
    inp = _inputs()
    out = {}
    for dtype in DTYPES:
        arch, jarch = _archs(dtype)
        jcfg = jarch.cfg
        jp = np_params(JD.param_specs(jcfg), seed=3)
        fwd = jax.jit(lambda p, x, t, y: JD.forward(p, jcfg, x, t, y))
        batch = {"latents": inp["x"], "t": inp["t"], "noise": inp["noise"],
                 "labels": inp["y2"]}
        r = dict(arch=arch, jp=jp,
                 eps=np.asarray(fwd(jp, inp["x"], inp["t"], inp["y"])),
                 eps2=np.asarray(fwd(jp, inp["x"], inp["t"], inp["y2"])),
                 loss=np.asarray(jax.jit(
                     lambda p, b: JD.loss_fn(p, jcfg, b))(jp, batch)),
                 ddim=np.asarray(jax.jit(
                     lambda p, x, t, tp, y: JD.ddim_step(p, jcfg, x, t, tp,
                                                         y))(
                     jp, inp["x"], inp["t"], inp["t_prev"], inp["y"])))
        for every in (1, 2):
            r[f"cache{every}"] = np.asarray(JD.sample_with_cache(
                        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(inp["x"]),
                TIMESTEPS, jnp.asarray(inp["y"]), refresh_every=every))
        jstate = {"params": jp, "opt": jax.tree.map(
            np.asarray, JS.OPT.init_state(jp))}
        jnew, jm = jax.jit(JS.make_train_fn(jarch))(jstate, batch)
        state = zoo_params_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
        new, m = S.make_train_fn(arch)(state, {k: _t(v)
                                               for k, v in batch.items()})
        r["step"] = dict(loss=float(m["loss"]), grad_norm=float(
            m["grad_norm"]), mu=_flat(PM.tree_leaves(new["opt"]["mu"])))
        r["jstep"] = dict(loss=float(jm["loss"]), grad_norm=float(
            jm["grad_norm"]), mu=_flat(jax.tree.leaves(jnew["opt"]["mu"])))
        out[dtype] = r
    return out


def _flat(leaves) -> np.ndarray:
    return np.concatenate([_np(x).ravel() for x in leaves])


def _port_params(r):
    return zoo_params_from_jax(r["jp"], "cpu")


def _tol(dtype):
    return F32_ATTN_TOL if dtype == "float32" else BF16_TOL


# ------------------------------------------------------------ pieces
def test_timestep_embedding():
    t = np.array([0, 1, 480, 500, 999], np.int32)
    ours = D.timestep_embedding(torch.from_numpy(t))
    ref = JD.timestep_embedding(jnp.asarray(t))
    assert ours.shape == (5, 256) and ours.dtype == torch.float32
    # sin and cos of angles up to 999 rad, f32 in both
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-4)
    assert _rel(ours[:, :128], np.asarray(ref)[:, :128]) <= 1e-4


@pytest.mark.parametrize("patch,hw,c", ((2, (8, 8), 4), (2, (6, 10), 4),
                                        (4, (8, 12), 3)))
def test_patchify_roundtrip(patch, hw, c):
    rng = np.random.default_rng(patch + c)
    x = rng.standard_normal((2, *hw, c)).astype(np.float32)
    ours, shape = D.patchify(torch.from_numpy(x), patch)
    ref, jshape = JD.patchify(jnp.asarray(x), patch)
    assert shape == tuple(jshape)
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))
    back = D.unpatchify(ours, shape, patch, c)
    np.testing.assert_array_equal(_np(back), x)
    np.testing.assert_array_equal(
        _np(back), np.asarray(JD.unpatchify(ref, jshape, patch, c)))


def test_alpha_bar_and_ddim_update():
    rng = np.random.default_rng(5)
    t = np.array([999, 500, 1, 0], np.int32)
    tp = np.array([749, 480, 0, 0], np.int32)
    xt = rng.standard_normal((4, 4, 4, 2)).astype(np.float32)
    eps = rng.standard_normal((4, 4, 4, 2)).astype(np.float32)
    assert _rel(D.alpha_bar(torch.from_numpy(t)),
                JD.alpha_bar(jnp.asarray(t))) <= F32_TOL
    assert _rel(D.ddim_update(*map(torch.from_numpy, (xt, eps, t, tp))),
                JD.ddim_update(*map(jnp.asarray, (xt, eps, t, tp)))) \
        <= F32_TOL


def test_take_clip_matches_the_reference_lookup():
    """``layers.take_clip`` against ``.at[idx].get(mode="clip")``, past
    both ends, and the LM's token embedding through it (it clamped a
    negative token to row 0, where the reference counts it from the
    end)."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((11, 5)).astype(np.float32)
    idx = np.array([[-13, -12, -11, -1], [0, 5, 10, 11]], np.int32)
    ref = np.asarray(jnp.asarray(table).at[idx].get(mode="clip"))
    np.testing.assert_array_equal(
        _np(L.take_clip(torch.from_numpy(table), torch.from_numpy(idx))),
        ref)
    arch = get_arch("llama3_2_1b", True)
    embed = torch.from_numpy(rng.standard_normal(
        (arch.cfg.vocab, arch.cfg.d_model)).astype(np.float32))
    tokens = np.array([[-1, 3, arch.cfg.vocab + 7]], np.int32)
    np.testing.assert_array_equal(
        _np(M._embed({"embed": embed}, arch.cfg, torch.from_numpy(tokens))),
        np.asarray(jnp.asarray(embed.numpy()).at[tokens].get(mode="clip")
                   .astype(jnp.bfloat16)).astype(np.float32))


# ------------------------------------------------------------ DiT
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_clips_labels(dit_ref, dtype):
    """Non-zero adaLN and final weights; labels 12 (past the 10 classes)
    and -1, then 3 and -13."""
    r = dit_ref[dtype]
    cfg = r["arch"].cfg
    p = _port_params(r)
    inp = _inputs()
    with torch.no_grad():
        eps = D.forward(p, cfg, _t(inp["x"]), _t(inp["t"]), _t(inp["y"]))
        eps2 = D.forward(p, cfg, _t(inp["x"]), _t(inp["t"]), _t(inp["y2"]))
        # 12 and -1 both read the null row; -13 reads row 0
        clamped = D.forward(p, cfg, _t(inp["x"]), _t(inp["t"]),
                            torch.tensor([10, 10]))
        low = D.forward(p, cfg, _t(inp["x"]), _t(inp["t"]),
                        torch.tensor([3, 0]))
    assert eps.dtype == torch.float32 and eps.shape == inp["x"].shape
    assert torch.equal(eps, clamped) and torch.equal(eps2, low)
    assert _rel(eps, r["eps"]) <= _tol(dtype)
    assert _rel(eps2, r["eps2"]) <= _tol(dtype)
    assert float(eps.abs().max()) > 0.1      # not the zero function


def test_reference_init_is_the_zero_function():
    """At the init rule the adaLN and final weights are zero, so the
    output is ``final_b`` = 0 in both packages (why the forward test
    draws them)."""
    arch = get_arch("dit_b2", True)
    p = PM.init_params(torch.Generator().manual_seed(0),
                       D.param_specs(arch.cfg), "cpu")
    x = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = D.forward(p, arch.cfg, x, torch.tensor([7]), torch.tensor([1]))
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_ddim_step(dit_ref, dtype):
    r = dit_ref[dtype]
    cfg = r["arch"].cfg
    p = _port_params(r)
    inp = _inputs()
    with torch.no_grad():
        loss = D.loss_fn(p, cfg, {"latents": _t(inp["x"]),
                                  "t": _t(inp["t"]),
                                  "noise": _t(inp["noise"]),
                                  "labels": _t(inp["y2"])})
        x = D.ddim_step(p, cfg, _t(inp["x"]), _t(inp["t"]),
                        _t(inp["t_prev"]), _t(inp["y"]))
    assert _rel(loss, r["loss"]) <= _tol(dtype)
    assert _rel(x, r["ddim"]) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("every", (1, 2))
def test_sample_with_cache(dit_ref, dtype, every, monkeypatch):
    """Four DDIM steps, the noise estimate refreshed every ``every``
    steps: 4 or 2 forwards, the result the reference's; refreshing every
    step is four plain ``ddim_step`` calls."""
    r = dit_ref[dtype]
    cfg = r["arch"].cfg
    p = _port_params(r)
    inp = _inputs()
    calls = []
    forward = D.forward
    monkeypatch.setattr(D, "forward", lambda *a: calls.append(1)
                        or forward(*a))
    with torch.no_grad():
        x = D.sample_with_cache(p, cfg, _t(inp["x"]), TIMESTEPS,
                                _t(inp["y"]), refresh_every=every)
    assert len(calls) == {1: 4, 2: 2}[every]
    assert _rel(x, r[f"cache{every}"]) <= _tol(dtype)
    if every == 1:
        steps = _t(inp["x"])
        with torch.no_grad():
            for t, tp in zip(TIMESTEPS, TIMESTEPS[1:]):
                steps = D.ddim_step(p, cfg, steps, torch.full((B,), t),
                                    torch.full((B,), tp), _t(inp["y"]))
        assert torch.equal(steps, x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_step(dit_ref, dtype):
    """One train step, the loss and gradients against the reference's
    jitted step (see the module's docstring)."""
    ours, ref = dit_ref[dtype]["step"], dit_ref[dtype]["jstep"]
    if dtype == "float32":
        assert _rel(ours["loss"], ref["loss"]) <= F32_ATTN_TOL
        assert _rel(ours["grad_norm"], ref["grad_norm"]) <= GRAD_ATTN_TOL
        assert _rel2(ours["mu"], ref["mu"]) <= GRAD_ATTN_TOL
        return
    exact = dit_ref["float32"]["jstep"]
    for key in ("loss", "mu"):
        err, own = _rel2(ours[key], exact[key]), _rel2(ref[key], exact[key])
        assert err <= BF16_SLACK * own + BF16_FLOOR, (key, err, own)
    assert _rel2(ours["loss"], ref["loss"]) <= BF16_TOL


# ------------------------------------------------------------ EDSR-lite
def test_edsr_forward_and_loss():
    cfg = JE.EDSRConfig()
    jp = np_params(JE.param_specs(cfg), seed=9)
    rng = np.random.default_rng(10)
    lr = rng.integers(0, 256, (2, 12, 20)).astype(np.float32)
    hd = rng.integers(0, 256, (2, 24, 40)).astype(np.float32)
    p = zoo_params_from_jax(jp, "cpu")
    ours_cfg = E.EDSRConfig()
    assert dataclasses.asdict(ours_cfg) == dataclasses.asdict(cfg)
    with torch.no_grad():
        out = E.forward(p, ours_cfg, torch.from_numpy(lr))
        loss = E.loss_fn(p, ours_cfg, torch.from_numpy(lr),
                         torch.from_numpy(hd))
    ref = JE.forward(jp, cfg, lr)
    assert out.shape == (2, 24, 40)
    assert _rel(out, ref) <= F32_TOL
    assert _rel(loss, JE.loss_fn(jp, cfg, lr, hd)) <= F32_TOL
    # the clamp bites: some outputs at 0 and 255 in both
    assert float(out.min()) == 0.0 and float(out.max()) == 255.0
    params = E.init(torch.Generator().manual_seed(0), ours_cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()
            if k != "blocks"} == {"head": (3, 3, 1, 16),
                                  "tail": (3, 3, 16, 1)}
    assert params["blocks"]["w1"].shape == (4, 3, 3, 16, 16)
