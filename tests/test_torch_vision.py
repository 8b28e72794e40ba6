"""The port's vision zoo on the CPU against the JAX package: ``layer_norm``
and ``gelu_mlp``, the NHWC convolution and max pool with XLA's "SAME"
rule, reduced ResNet-50 (eval and train forward, the new batch_stats, the
train step), ConvNeXt-B and ViT-B/16 (forward, ViT's ``features``, the
losses, ViT's train step), each in f32 (``dataclasses.replace(cfg,
dtype="float32")``) and in the reference's bf16.  Both packages take the
same seeded numpy parameters (``zoo_params_from_jax``; f32 draws, rounded
for bf16) and images, B = 2: 32 px, and 64 px for ResNet (at 32 px its
last stage is 1x1, and a training BatchNorm there normalises two values a
channel).  The reference's outputs are computed once a model and dtype,
in module-scoped fixtures.

Tolerances.  ``_rel`` is the largest difference over the reference's
largest magnitude, ``_rel2`` the relative L2 distance (over all leaves of
a tree).  f32: outputs and running stats within ``F32_TOL`` (1e-5; sums
in another order, oneDNN against Eigen), the train step's loss within
``F32_TOL``, its gradient norm and every gradient leaf (through AdamW's
first moment ``opt["mu"]``, 0.1 times the clipped gradient at the first
step, where the learning rate is still 0) within ``GRAD_F32_TOL`` (1e-4)
in ``_rel2``.  ViT's ``chunked_attention`` takes q, k and v in bf16 in
both packages, so an f32 value a rounding apart can flip a bf16 ulp:
ViT's outputs within ``F32_ATTN_TOL`` (2e-3), and its gradients within
``GRAD_ATTN_TOL`` (2^-6), because the backward takes bf16 cotangents
through those casts in both packages, each rounded at 2^-9 (measured:
5.5e-4 on one leaf; 3e-3 for DiT in ``tests/test_torch_dit.py``).
bf16: each package rounds every layer's activations, and a one-ulp
difference early on moves the later layers, most of all through a
training BatchNorm, whose backward differences terms of the size of the
rounding (the reference's own bf16 ResNet gradient is ~40 % from its f32
one here).  So a bf16 result is held by its distance to the reference's
f32 result, which must be within ``BF16_SLACK`` (3) times the
reference's own bf16 distance plus ``BF16_FLOOR`` (2^-7) (measured: up
to 2.05 times, ResNet's train-mode logits); the gradient norm within
that many times the gradient's own distance (|‖a‖ - ‖b‖| <= ‖a - b‖);
the eval forwards also directly within ``BF16_TOL`` (0.05) of the
reference's bf16 outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import ShapeCase as JShapeCase
from repro.configs import get_arch as j_get_arch
from repro.launch import steps as JS
from repro.models import convnext as JC
from repro.models import layers as JL
from repro.models import resnet as JR
from repro.models import vit as JV
from repro.models.params import is_spec
from repro_torch.configs import ShapeCase, get_arch
from repro_torch.launch import steps as S
from repro_torch.models import convnext as C
from repro_torch.models import layers as L
from repro_torch.models import params as PM
from repro_torch.models import resnet as R
from repro_torch.models import vit as V
from repro_torch.models.weights import zoo_params_from_jax

F32_TOL = 1e-5
F32_ATTN_TOL = 2e-3
GRAD_ATTN_TOL = 2 ** -6
GRAD_F32_TOL = 1e-4
BF16_TOL = 0.05
BF16_SLACK = 3.0
BF16_FLOOR = 2 ** -7
DTYPES = ("float32", "bfloat16")
B, RES, RESNET_RES = 2, 32, 64


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


def _flat(tree) -> np.ndarray:
    """All leaves of a port (torch) or reference (numpy) tree, in sorted
    key order, as one f32 vector."""
    leaves = PM.tree_leaves(tree) if isinstance(
        PM.tree_leaves(tree)[0], torch.Tensor) else jax.tree.leaves(tree)
    return np.concatenate([_np(x).ravel() for x in leaves])


def _rel2(ours, ref) -> float:
    ours, ref = _np(ours).ravel(), _np(ref).ravel()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref),
                                                  1e-30))


def _hold(ours, ref: dict, dtype: str, key, metric=_rel,
          f32_tol=F32_TOL) -> float:
    """``ours`` against ``ref[dtype][key]`` by ``metric``; in bf16 by its
    distance to ``ref["float32"][key]`` (see the module's docstring).
    Returns the distance held."""
    got = ref[dtype][key]
    if dtype == "float32":
        err = metric(ours, got)
        assert err <= f32_tol, (key, err)
        return err
    exact = ref["float32"][key]
    err, own = metric(ours, exact), metric(got, exact)
    assert err <= BF16_SLACK * own + BF16_FLOOR, (key, err, own)
    return err


def np_params(specs, seed: int):
    """Numpy parameters for a reference spec tree, every leaf random (so
    that no bias or scale is an identity): fan-in and normal leaves by
    their rule, ``ones`` 1 + N(0, 0.1), ``zeros`` N(0, 0.1); a ``var``
    leaf (ResNet's running variance) uniform in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten_with_path(specs, is_leaf=is_spec)
    out = []
    for path, s in leaves:
        z = rng.standard_normal(s.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "var":
            a = rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        elif s.init == "fan_in":
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


def _archs(arch_id: str, dtype: str):
    ours, ref = get_arch(arch_id, True), j_get_arch(arch_id, True)
    return (dataclasses.replace(ours, cfg=dataclasses.replace(
                ours.cfg, dtype=dtype)),
            dataclasses.replace(ref, cfg=dataclasses.replace(
                ref.cfg, dtype=dtype)))


def _images(seed: int = 0, res: int = RES):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, res, res, 3)).astype(np.float32)


def _labels():
    return np.array([3, 7], np.int32)


def _step_both(arch, jarch, jstate, batch):
    """One train step of each package on the same state and batch: (the
    port's (state, metrics), the reference's as numpy)."""
    jstep = jax.jit(JS.make_train_fn(jarch))
    jnew, jm = jstep(jstate, batch)
    state = zoo_params_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    new, m = S.make_train_fn(arch)(state, {k: _t(v)
                                           for k, v in batch.items()})
    return (new, m), (jax.tree.map(np.asarray, jnew),
                      jax.tree.map(np.asarray, jm))


def _step_outputs(step) -> tuple[dict, dict]:
    """The port's and the reference's loss, gradient norm and mu."""
    (new, m), (jnew, jm) = step
    return ({"loss": m["loss"], "grad_norm": m["grad_norm"],
             "mu": new["opt"]["mu"]},
            {"loss": jm["loss"], "grad_norm": jm["grad_norm"],
             "mu": jnew["opt"]["mu"]})


def _hold_step(ref: dict, dtype: str, grad_tol=GRAD_F32_TOL) -> dict:
    """The train step held (see the module's docstring), the f32 gradient
    norm and each gradient leaf within ``grad_tol``; ``ref[dtype]
    ["step"]`` from :func:`_step_both`.  Returns the port's new state."""
    ours, _ = _step_outputs(ref[dtype]["step"])
    refs = {d: dict(zip(("loss", "grad_norm", "mu"), (
        lambda r: (r["loss"], r["grad_norm"], _flat(r["mu"])))(
        _step_outputs(ref[d]["step"])[1]))) for d in ref}
    _hold(ours["loss"], refs, dtype, "loss")
    noise = _hold(_flat(ours["mu"]), refs, dtype, "mu", metric=_rel2,
                  f32_tol=grad_tol)
    if dtype == "float32":
        _hold(ours["grad_norm"], refs, dtype, "grad_norm", f32_tol=grad_tol)
        jmu = jax.tree.leaves(ref[dtype]["step"][1][0]["opt"]["mu"])
        mu = PM.tree_leaves(ours["mu"])
        assert len(mu) == len(jmu)
        worst = max(_rel2(a, b) for a, b in zip(mu, jmu))
        assert worst <= grad_tol, worst
    else:
        # |‖a‖ - ‖b‖| <= ‖a - b‖: a gradient as far from the exact one as
        # the reference's own bf16 gradient moves its norm by that much
        own = _rel2(refs[dtype]["mu"], refs["float32"]["mu"])
        gn = abs(float(ours["grad_norm"]) / float(
            refs["float32"]["grad_norm"]) - 1)
        assert gn <= BF16_SLACK * max(noise, own) + BF16_FLOOR, (gn, own)
    return ref[dtype]["step"][0][0]


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_and_gelu_mlp(dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.dtype(dtype)
    x = rng.standard_normal((2, 5, 48)).astype(jdt)
    w, b = (1 + 0.1 * rng.standard_normal(48)).astype(jdt), \
        (0.1 * rng.standard_normal(48)).astype(jdt)
    w1 = (rng.standard_normal((48, 96)) / 7).astype(jdt)
    b1 = (0.1 * rng.standard_normal(96)).astype(jdt)
    w2 = (rng.standard_normal((96, 48)) / 10).astype(jdt)
    b2 = (0.1 * rng.standard_normal(48)).astype(jdt)
    t = {k: _t(v) for k, v in
         dict(x=x, w=w, b=b, w1=w1, b1=b1, w2=w2, b2=b2).items()}
    ln = L.layer_norm(t["x"], t["w"], t["b"])
    jln = JL.layer_norm(x, w, b)
    assert ln.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else 2 ** -7
    assert _rel(ln, jln) <= tol
    mlp = L.gelu_mlp(t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    jmlp = JL.gelu_mlp(x, w1, b1, w2, b2)
    assert _rel(mlp, jmlp) <= tol
    # jax.nn.gelu's default is the tanh form, not the exact GELU
    one = torch.ones(1)
    assert abs(float(torch.nn.functional.gelu(one, approximate="tanh"))
               - float(jax.nn.gelu(1.0))) < 1e-6
    assert abs(float(torch.nn.functional.gelu(one))
               - float(jax.nn.gelu(1.0))) > 1e-4


CONV_CASES = [(size, k, stride) for size in (7, 8, 9) for k in (1, 3, 7)
              for stride in (1, 2)]


@pytest.mark.parametrize("size,k,stride", CONV_CASES)
def test_conv_same_matches_lax(size, k, stride):
    """XLA's "SAME" puts the odd pixel after: odd and even sizes, strides
    1 and 2, and a channel group a channel (ConvNeXt's depthwise form)."""
    rng = np.random.default_rng(size * 100 + k * 10 + stride)
    x = rng.standard_normal((2, size, size + 1, 6)).astype(np.float32)
    w = rng.standard_normal((k, k, 6, 5)).astype(np.float32)
    ref = lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                   dimension_numbers=("NHWC", "HWIO",
                                                      "NHWC"))
    ours = L.conv_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                       stride=stride)
    assert _rel(ours, ref) <= F32_TOL
    dw = rng.standard_normal((k, k, 1, 6)).astype(np.float32)
    ref = lax.conv_general_dilated(x, dw, (stride, stride), "SAME",
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   feature_group_count=6)
    ours = L.conv_nhwc(torch.from_numpy(x), torch.from_numpy(dw),
                       stride=stride, groups=6)
    assert _rel(ours, ref) <= F32_TOL


def test_conv_same_is_not_symmetric_padding():
    """On an even size a 3x3 stride-2 "SAME" pads (0, 1): padding (1, 1),
    ``F.conv2d``'s ``padding=1``, reads other pixels."""
    assert L.same_pad(8, 3, 2) == (0, 1)
    assert L.same_pad(224, 7, 2) == (2, 3)
    assert L.same_pad(9, 3, 2) == (1, 1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 8, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 3)).astype(np.float32)
    ref = lax.conv_general_dilated(x, w, (2, 2), "SAME",
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"))
    sym = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
    assert _rel(sym.permute(0, 2, 3, 1), ref) > 0.1
    with pytest.raises(ValueError, match="SAME"):
        L.conv_nhwc(torch.from_numpy(x), torch.from_numpy(w), padding=1)


@pytest.mark.parametrize("size", (7, 8, 9, 16))
@pytest.mark.parametrize("stride", (1, 2))
def test_max_pool_same_matches_reduce_window(size, stride):
    rng = np.random.default_rng(size + stride)
    # all negative, so a zero pad would show
    x = -np.abs(rng.standard_normal((2, size, size + 1, 3))) \
        .astype(np.float32) - 1
    ref = lax.reduce_window(x, -jnp.inf, lax.max, (1, 3, 3, 1),
                            (1, stride, stride, 1), "SAME")
    ours = L.max_pool_nhwc(torch.from_numpy(x), 3, stride)
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))


@pytest.mark.parametrize("k,stride", ((4, 4), (2, 2), (8, 8)))
def test_conv_valid_matches_lax(k, stride):
    """The VALID patch convolutions: ConvNeXt's stem and downsample, ViT's
    patch embedding."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 17, 16, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 8)).astype(np.float32)
    ref = lax.conv_general_dilated(x, w, (stride, stride), "VALID",
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ours = L.conv_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                       stride=stride, padding="VALID")
    assert _rel(ours, ref) <= F32_TOL


# ------------------------------------------------------------ ResNet
@pytest.fixture(scope="module")
def resnet_ref():
    """Per dtype: the archs, the numpy variables, and the reference's eval
    logits, train logits and new stats, and one train step of each
    package."""
    out = {}
    images = _images(res=RESNET_RES)
    for dtype in DTYPES:
        arch, jarch = _archs("resnet_50", dtype)
        jcfg = jarch.cfg
        jv = np_params(JR.param_specs(jcfg), seed=1)
        fwd = jax.jit(lambda v, x, train: JR.forward(v, jcfg, x, train),
                      static_argnums=2)
        ev, _ = fwd(jv, images, False)
        tr, st = fwd(jv, images, True)
        jstate = {"params": jv["params"], "batch_stats": jv["batch_stats"],
                  "opt": jax.tree.map(np.asarray, JS.OPT.init_state(
                      jv["params"]))}
        batch = {"images": images.astype(jnp.bfloat16), "labels": _labels()}
        step = _step_both(arch, jarch, jstate, batch)
        out[dtype] = dict(arch=arch, jv=jv, eval=np.asarray(ev),
                          train=np.asarray(tr),
                          stats=_flat(jax.tree.map(np.asarray, st)),
                          step=step,
                          step_stats=_flat(step[1][0]["batch_stats"]))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_resnet_forward_eval_and_train(resnet_ref, dtype):
    r = resnet_ref[dtype]
    cfg = r["arch"].cfg
    v = zoo_params_from_jax(r["jv"], "cpu")
    x = torch.from_numpy(_images(res=RESNET_RES))
    with torch.no_grad():
        ev, same = R.forward(v, cfg, x, train=False)
        tr, st = R.forward(v, cfg, x, train=True)
    assert same is v["batch_stats"]
    _hold(ev, resnet_ref, dtype, "eval")
    if dtype == "bfloat16":
        assert _rel(ev, r["eval"]) <= BF16_TOL
    _hold(tr, resnet_ref, dtype, "train")
    # the new stats: the reference's nesting, shapes and dtype; moved from
    # the old by momentum * old + (1 - momentum) * the batch's
    flat = PM.tree_leaves(st)
    assert [tuple(t.shape) for t in flat] == \
        [a.shape for a in jax.tree.leaves(r["jv"]["batch_stats"])]
    assert all(t.dtype == torch.float32 for t in flat)
    _hold(_flat(st), resnet_ref, dtype, "stats", metric=_rel2)
    old = PM.tree_leaves(v["batch_stats"])
    assert all(not torch.equal(a, b) for a, b in zip(flat, old))


def test_resnet_stats_are_the_population_variance_with_momentum():
    """The stem's new stats from the stem activations themselves: the
    batch mean and the ddof-0 variance, mixed 0.9 old / 0.1 new."""
    arch, jarch = _archs("resnet_50", "float32")
    cfg = arch.cfg
    v = zoo_params_from_jax(np_params(JR.param_specs(jarch.cfg), seed=2),
                            "cpu")
    x = torch.from_numpy(_images(3))
    with torch.no_grad():
        _, st = R.forward(v, cfg, x, train=True)
        h = L.conv_nhwc(x, v["params"]["stem_conv"][0], stride=2)
    old = v["batch_stats"]["stem_bn"]
    mean = h.mean(dim=(0, 1, 2))
    var = h.var(dim=(0, 1, 2), unbiased=False)
    torch.testing.assert_close(st["stem_bn"]["mean"][0],
                               0.9 * old["mean"][0] + 0.1 * mean)
    torch.testing.assert_close(st["stem_bn"]["var"][0],
                               0.9 * old["var"][0] + 0.1 * var)
    unbiased = 0.9 * old["var"][0] + 0.1 * h.var(dim=(0, 1, 2))
    assert not torch.allclose(st["stem_bn"]["var"][0], unbiased, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resnet_train_step(resnet_ref, dtype):
    """The stats family's step against the reference's jitted step: loss,
    gradient norm, the gradients through mu, and the new batch_stats
    (detached), as the train forward's."""
    new = _hold_step(resnet_ref, dtype)
    assert set(new) == {"params", "opt", "batch_stats"}
    assert not any(t.requires_grad
                   for t in PM.tree_leaves(new["batch_stats"]))
    _hold(_flat(new["batch_stats"]), resnet_ref, dtype, "step_stats",
          metric=_rel2)


# ------------------------------------------------------------ ConvNeXt
@pytest.fixture(scope="module")
def convnext_ref():
    out = {}
    images = _images(4)
    for dtype in DTYPES:
        arch, jarch = _archs("convnext_b", dtype)
        jcfg = jarch.cfg
        jp = np_params(JC.param_specs(jcfg), seed=5)
        logits = jax.jit(lambda p, x: JC.forward(p, jcfg, x))(jp, images)
        loss = jax.jit(lambda p, b: JC.loss_fn(p, jcfg, b))(
            jp, {"images": images, "labels": _labels()})
        out[dtype] = dict(arch=arch, jp=jp, logits=np.asarray(logits),
                          loss=np.asarray(loss))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_convnext_forward_and_loss(convnext_ref, dtype):
    r = convnext_ref[dtype]
    cfg = r["arch"].cfg
    p = zoo_params_from_jax(r["jp"], "cpu")
    x = torch.from_numpy(_images(4))
    with torch.no_grad():
        logits = C.forward(p, cfg, x)
        loss = C.loss_fn(p, cfg, {"images": x,
                                  "labels": torch.from_numpy(_labels())})
    assert logits.dtype == torch.float32
    _hold(logits, convnext_ref, dtype, "logits")
    if dtype == "bfloat16":
        assert _rel(logits, r["logits"]) <= BF16_TOL
    _hold(loss, convnext_ref, dtype, "loss")


def test_convnext_gamma_starts_at_one():
    """``gamma``'s "ones" rule ignores ``scale=ls_init`` in both packages."""
    arch = get_arch("convnext_b", True)
    p = PM.init_params(torch.Generator().manual_seed(0),
                       C.param_specs(arch.cfg), "cpu")
    assert torch.equal(p["s0"]["gamma"], torch.ones_like(p["s0"]["gamma"]))
    j = JC.param_specs(j_get_arch("convnext_b", True).cfg)["s0"]["gamma"]
    assert (j.init, j.scale) == ("ones", 1e-6)


# ------------------------------------------------------------ ViT
@pytest.fixture(scope="module")
def vit_ref():
    out = {}
    images = _images(6)
    for dtype in DTYPES:
        arch, jarch = _archs("vit_b16", dtype)
        jcfg = jarch.cfg
        jp = np_params(JV.param_specs(jcfg), seed=7)
        logits = jax.jit(lambda p, x: JV.forward(p, jcfg, x))(jp, images)
        feats = jax.jit(lambda p, x: JV.features(p, jcfg, x))(jp, images)
        jstate = {"params": jp, "opt": jax.tree.map(
            np.asarray, JS.OPT.init_state(jp))}
        batch = {"images": images.astype(jnp.bfloat16), "labels": _labels()}
        out[dtype] = dict(arch=arch, jp=jp, logits=np.asarray(logits),
                          feats=np.asarray(feats),
                          step=_step_both(arch, jarch, jstate, batch))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_forward_and_features(vit_ref, dtype):
    r = vit_ref[dtype]
    cfg = r["arch"].cfg
    p = zoo_params_from_jax(r["jp"], "cpu")
    x = torch.from_numpy(_images(6))
    with torch.no_grad():
        logits = V.forward(p, cfg, x)
        feats = V.features(p, cfg, x)
    assert feats.shape == (B, RES // cfg.patch, RES // cfg.patch,
                           cfg.d_model)
    assert feats.dtype == getattr(torch, dtype)
    _hold(logits, vit_ref, dtype, "logits", f32_tol=F32_ATTN_TOL)
    _hold(feats, vit_ref, dtype, "feats", f32_tol=F32_ATTN_TOL)
    if dtype == "bfloat16":
        assert _rel(logits, r["logits"]) <= BF16_TOL
        assert _rel(feats, r["feats"]) <= BF16_TOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_train_step(vit_ref, dtype):
    """A family without stats: ``loss_fn`` through the step's loss, and
    the gradients through mu."""
    assert set(_hold_step(vit_ref, dtype, GRAD_ATTN_TOL)) == {"params",
                                                             "opt"}


def test_vision_cells_against_the_reference():
    """``build_cell`` and ``materialize`` of the vision cells: the
    arguments' structure, shapes and dtypes as the reference's."""
    for arch_id in ("resnet_50", "convnext_b", "vit_b16"):
        arch, jarch = get_arch(arch_id, True), j_get_arch(arch_id, True)
        for kind in ("train", "infer"):
            case = ShapeCase("c", kind, batch=B, img_res=RES)
            jcase = JShapeCase("c", kind, batch=B, img_res=RES)
            args = S.materialize(torch.Generator().manual_seed(0), arch,
                                 case, "cpu")
            cell = S.build_cell(arch, case)
            jargs = JS.build_cell(jarch, jcase).args
            for got, meta, ref in zip(args, cell.args, jargs):
                shapes = [(tuple(t.shape), str(t.dtype).split(".")[-1])
                          for t in PM.tree_leaves(got)]
                assert shapes == [(tuple(t.shape), str(t.dtype).split(".")[
                    -1]) for t in PM.tree_leaves(meta)]
                assert shapes == [(tuple(a.shape), str(a.dtype))
                                  for a in jax.tree.leaves(ref)], arch_id
            out = cell.fn(*args)
            if kind == "infer":
                assert out.shape == (B, arch.cfg.n_classes)
            else:
                assert np.isfinite(float(out[1]["loss"]))
