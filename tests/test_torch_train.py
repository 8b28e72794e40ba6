"""The port's training stack on the CPU against the JAX package: gradient
compression, the loop and supervised restarts, the LM loss and train step
(reduced llama3.2-1B, the reference's weights carried across by
``lm_params_from_jax``), ``build_cell``, the detector's fit step, serve
with a detector checkpoint, the launchers, and the kernels' grad guard.

Contracts, each checked below:
- compression, the loop's history (``steps_per_s`` aside), restarts and
  the steps on disk: equal, bit for bit;
- ``softmax_xent``: the gold logit exactly, the loss within rtol 1e-6
  (the two libraries' log-sum-exp may part in the last bit);
- one train step with f32 activations (``dtype="float32"``): loss within
  rtol 1e-5, grad norm within rtol 1e-4, lr exact; the optimiser's first
  moment ``mu`` (0.1 x the clipped gradient) and second ``nu``, leaf by
  leaf, within 5e-3 of the leaf's max |ref| element by element and in
  norm (measured: loss 3.4e-7, norm 2.4e-5, mu 1.8e-3, nu 2.6e-3 of the
  max: both packages' attention rounds q, k, v and the probabilities to
  bf16 whatever the activations' dtype, so the gradients part at bf16's
  rounding); the updated params within 2·lr + 1e-7 (Adam's first step
  moves each weight by about ±lr, so this bound only pins the step's
  size: ``mu`` is what pins the gradient);
- with the published bf16 activations: loss within rtol 1e-5, grad norm
  within rtol 2e-2, mu and nu within 1e-1 of each leaf's max |ref|
  element by element and in norm, params within 2·lr + one bf16 ulp
  (measured: loss 1.6e-6, norm 1.0e-2: the reference sums the embedding
  lookup's gradient less exactly, 13.23 against 13.10 for the port and
  13.11 for the same weights in f32; mu 4.8e-2, nu 5.2e-2 of the max);
- remat on and off: the same bits;
- the detector's 5 fit steps: loss and params within rtol 1e-4
  (``tests/test_torch_serving.py``'s detector contract).
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeCase as JShapeCase
from repro.configs import get_arch as j_get_arch
from repro.launch import steps as JS
from repro.models import detection as JD
from repro.models import transformer_lm as JM
from repro.models.params import init_params as j_init_params
from repro.sim import video_source as JV
from repro.train import checkpoint as JCKPT
from repro.train import compression as JCOMP
from repro.train import fault_tolerance as JFT
from repro.train import loop as JLOOP
from repro.train import optimizer as JO
from repro_torch.configs import ShapeCase, get_arch
from repro_torch.kernels import build
from repro_torch.kernels.blockdct import ops as blockdct_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.motion_sad.ops import motion_sad
from repro_torch.kernels.qtransfer.ops import qtransfer
from repro_torch.kernels.roi_gather.ops import roi_gather
from repro_torch.kernels.seq_sum.ops import seq_sum
from repro_torch.launch import serve as LS
from repro_torch.launch import steps as S
from repro_torch.launch import train as LT
from repro_torch.launch import train_detector as LTD
from repro_torch.models import detection as D
from repro_torch.models import params as PM
from repro_torch.models import transformer_lm as M
from repro_torch.models.weights import (detector_params_from_jax,
                                        lm_params_from_jax)
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import compression as COMP
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import loop as LOOP
from repro_torch.train import optimizer as OPT


def _np(x):
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("scheme", ["none", "topk", "int8", "topk_int8"])
def test_compression_equals_reference_bit_for_bit(scheme):
    """Three steps of error feedback on gradients with many ties in |g|
    (a coarse grid, both signs): outputs, errors and wire bytes equal."""
    rng = np.random.default_rng(0)
    grads = {"w": (rng.integers(-4, 5, (64,)) / 4).astype(np.float32),
             "blk": {"m": (rng.integers(-3, 4, (4, 8)) / 8)
                     .astype(np.float32),
                     "s": np.full((5,), 0.5, np.float32)}}
    cfg = COMP.CompressionConfig(scheme=scheme, topk_fraction=0.1)
    jcfg = JCOMP.CompressionConfig(scheme=scheme, topk_fraction=0.1)
    tg = PM.tree_map(torch.from_numpy, grads)
    jg = jax.tree.map(jnp.asarray, grads)
    err, jerr = COMP.init_error(tg), JCOMP.init_error(jg)
    for _ in range(3):
        out, err = COMP.compress(cfg, tg, err)
        jout, jerr = JCOMP.compress(jcfg, jg, jerr)
        for a, b in zip(PM.tree_leaves(out) + PM.tree_leaves(err),
                        jax.tree.leaves(jout) + jax.tree.leaves(jerr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert COMP.compressed_bytes(cfg, tg) == \
        JCOMP.compressed_bytes(jcfg, jg)


# ------------------------------------------------------ loop, supervise
def _steps(rng, n=10):
    return [rng.normal(0, 1, (4,)).astype(np.float32) for _ in range(n)]


def _step(state, batch):
    """One step of either package (tensors or jax arrays)."""
    w = state["w"] * 0.5 + batch
    return {"w": w, "n": state["n"] + 1}, {"loss": (w * w).sum(),
                                           "n": state["n"]}


def _data(pkg, batches, ckpt_dir):
    """A data pipeline that resumes where the latest checkpoint ends."""
    start = pkg.latest_step(ckpt_dir) or 0
    conv = torch.from_numpy if pkg is CKPT else jnp.asarray
    return iter([conv(b) for b in batches[start:]])


def _strip(hist):
    return [{k: v for k, v in m.items() if k != "steps_per_s"}
            for m in hist]


@pytest.mark.parametrize("async_ckpt,keep", [(False, 3), (True, 2)])
def test_loop_and_supervise_match_reference(tmp_path, async_ckpt, keep):
    batches = _steps(np.random.default_rng(1))
    threads = set(threading.enumerate())

    def join_writers(*_):
        """Wait for the checkpoint writers that ``async_ckpt`` started."""
        for t in set(threading.enumerate()) - threads:
            t.join(timeout=60)
            assert not t.is_alive()

    runs = {}
    for name, pkg, loop, ft, init in (
            ("port", CKPT, LOOP, FT, lambda: {
                "w": torch.zeros(4), "n": torch.tensor(0, dtype=torch.int32)}),
            ("ref", JCKPT, JLOOP, JFT, lambda: {
                "w": jnp.zeros(4), "n": jnp.asarray(0, jnp.int32)})):
        step = _step
        d = str(tmp_path / name)
        cfg = loop.LoopConfig(total_steps=6, ckpt_dir=d, ckpt_every=2,
                              log_every=2, async_ckpt=async_ckpt, keep=keep)
        # a run, then its resume to 8 steps (an async writer is joined
        # before the next run looks for the latest step)
        state, hist = loop.run(step, init(), _data(pkg, batches, d), cfg)
        join_writers()
        cfg8 = dataclasses.replace(cfg, total_steps=8)
        state8, hist8 = loop.run(step, init(), _data(pkg, batches, d), cfg8)
        join_writers()
        # a supervised run with a failure at step 3: one restart from 2
        d2 = str(tmp_path / f"{name}_ft")
        cfg2 = dataclasses.replace(cfg, ckpt_dir=d2, log_every=1)
        res = ft.supervise(lambda attempt: (step, init(), None),
                           lambda: _data(pkg, batches, d2), cfg2,
                           fail_injector=lambda s: s == 3,
                           on_restart=join_writers)
        join_writers()
        runs[name] = dict(
            final=_np(state["w"]), final8=_np(state8["w"]),
            n=int(state8["n"]), hist=_strip(hist), hist8=_strip(hist8),
            steps=pkg.all_steps(d), ft_final=_np(res.state["w"]),
            ft_hist=_strip(res.history), restarts=res.restarts,
            ft_steps=pkg.all_steps(d2))
    ours, ref = runs["port"], runs["ref"]
    assert ours["restarts"] == ref["restarts"] == 1
    assert ours["n"] == ref["n"] == 8
    assert ours["hist8"][0]["step"] == 8
    for key in ("hist", "hist8", "ft_hist", "steps", "ft_steps"):
        assert ours[key] == ref[key], key
    for key in ("final", "final8", "ft_final"):
        np.testing.assert_array_equal(ours[key], ref[key])
    # lost work is bounded by ckpt_every: the restarted run equals the
    # unbroken one
    np.testing.assert_array_equal(ours["ft_final"], ours["final"])


def join_writers():
    """Wait for the checkpoint writers of ``async_ckpt`` (daemon threads)."""
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=60)
            assert not t.is_alive()


def test_metrics_reach_the_host_once_a_log_point(monkeypatch):
    """The loop copies a log point's metrics in one transfer and leaves
    the steps between on the device."""
    calls = []
    host = LOOP._host_metrics

    def counted(m):
        calls.append(sorted(m))
        return host(m)

    monkeypatch.setattr(LOOP, "_host_metrics", counted)
    cfg = LOOP.LoopConfig(total_steps=7, log_every=3)
    _, hist = LOOP.run(_step, {"w": torch.zeros(4),
                                    "n": torch.tensor(0)},
                       iter(torch.ones(7, 4)), cfg)
    assert [m["step"] for m in hist] == [3, 6, 7] and len(calls) == 3
    assert hist[0]["n"] == 2.0 and isinstance(hist[0]["loss"], float)


# ---------------------------------------------------------------- the LM
def _lm(dtype):
    """Reduced llama3.2-1B in both packages, the reference's weights
    carried across (bf16: ``lm_params_from_jax``; f32: as they are)."""
    ours, ref = get_arch("llama3_2_1b", True), j_get_arch("llama3_2_1b", True)
    ours = dataclasses.replace(ours, cfg=dataclasses.replace(ours.cfg,
                                                             dtype=dtype))
    ref = dataclasses.replace(ref, cfg=dataclasses.replace(ref.cfg,
                                                           dtype=dtype))
    jp = j_init_params(jax.random.PRNGKey(0), JM.param_specs(ref.cfg))
    host = jax.tree.map(np.asarray, jp)
    tp = lm_params_from_jax(host, device="cpu") if dtype == "bfloat16" \
        else jax.tree.map(lambda a: torch.from_numpy(np.array(a)), host)
    toks = np.random.default_rng(1).integers(0, ours.cfg.vocab, (4, 32)) \
        .astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    return ours, ref, tp, jp, batch


@pytest.fixture(scope="module")
def lm_bf16():
    return _lm("bfloat16")


@pytest.fixture(scope="module")
def lm_f32():
    return _lm("float32")


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_softmax_xent_and_loss_match_reference(lm_bf16):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 4, (3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    ours = M.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = JM.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)
    gold = torch.from_numpy(logits).gather(
        -1, torch.from_numpy(labels).long()[..., None])[..., 0]
    onehot = jax.nn.one_hot(labels, 50, dtype=jnp.float32)
    np.testing.assert_array_equal(
        gold.numpy(), np.asarray(jnp.einsum("...v,...v->...", logits,
                                            onehot)))
    arch, jarch, tp, jp, batch = lm_bf16
    loss = M.loss_fn(tp, arch.cfg, _tb(batch))
    jloss = JM.loss_fn(jp, jarch.cfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(lm_f32, lm_bf16, dtype, grad_accum):
    arch, jarch, tp, jp, batch = lm_f32 if dtype == "float32" else lm_bf16
    jstep = jax.jit(JS.make_train_fn(jarch, grad_accum))
    jnew, jm = jstep({"params": jp, "opt": JO.init_state(jp)},
                     {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = S.make_train_fn(arch, grad_accum)(
        {"params": tp, "opt": OPT.init_state(tp)}, _tb(batch))
    assert set(m) == set(jm) == {"loss", "grad_norm", "lr"}
    norm_tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=norm_tol)
    assert m["lr"].item() == float(jm["lr"])
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    lr = float(jm["lr"])
    for (k, a), b in zip(CKPT._flatten(new["params"]),
                         jax.tree.leaves(jnew["params"])):
        a, b = _np(a.float()), _np(b)
        ulp = 0.0 if dtype == "float32" else np.abs(b) * 2.0 ** -7
        assert (np.abs(a - b) <= 2 * lr + 1e-7 + ulp).all(), k
    moment_tol = 5e-3 if dtype == "float32" else 1e-1
    for name in ("mu", "nu"):
        for (k, a), b in zip(CKPT._flatten(new["opt"][name]),
                             jax.tree.leaves(jnew["opt"][name])):
            assert a.dtype == torch.float32 and a.shape == b.shape, k
            a, b = a.numpy(), _np(b)
            scale = np.abs(b).max()
            assert scale > 0, (name, k)
            assert np.abs(a - b).max() <= moment_tol * scale, (name, k)
            assert np.linalg.norm(a - b) <= moment_tol * np.linalg.norm(b), \
                (name, k)


def test_grad_accum_and_remat_keep_values(lm_bf16):
    """In the port: grad_accum 2 against 1 on one batch (the losses
    within f32 rounding, the f32 sums of the two halves' bf16 gradients
    within one bf16 ulp of the whole batch's), remat on and off the same
    bits."""
    arch, _, tp, _, batch = lm_bf16
    state = {"params": tp, "opt": OPT.init_state(tp)}
    _, m1 = S.make_train_fn(arch, 1)(state, _tb(batch))
    _, m2 = S.make_train_fn(arch, 2)(state, _tb(batch))
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=2 ** -8)
    assert arch.cfg.remat is False
    remat = dataclasses.replace(arch.cfg, remat=True)
    l0, g0, _ = S._grads_of(lambda p, b: (M.loss_fn(p, arch.cfg, b), None),
                            tp, _tb(batch))
    l1, g1, _ = S._grads_of(lambda p, b: (M.loss_fn(p, remat, b), None),
                            tp, _tb(batch))
    assert torch.equal(l0, l1)
    for a, b in zip(PM.tree_leaves(g0), PM.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_grad_accum_dtype_is_settable(lm_bf16, monkeypatch):
    """bf16 accumulators in both packages: the gradients that reach AdamW
    are bf16 in each, the port's equal to its f32 accumulators' sum
    rounded to bf16 (two bf16 halves sum exactly in f32, so the bf16 sum
    is that sum's one rounding) and not equal to it unrounded; the loss
    and grad norm within the bf16 train step's tolerances of the
    reference's."""
    arch, jarch, tp, jp, batch = lm_bf16
    assert S.GRAD_ACCUM_DTYPE == torch.float32
    assert JS.GRAD_ACCUM_DTYPE == jnp.float32
    seen, jseen = [], []

    def spy(apply, out):
        def call(params, grads, *a, **k):
            out.append(grads)
            return apply(params, grads, *a, **k)
        return call

    monkeypatch.setattr(S.OPT, "apply_updates",
                        spy(S.OPT.apply_updates, seen))
    monkeypatch.setattr(JS.OPT, "apply_updates",
                        spy(JS.OPT.apply_updates, jseen))
    state = {"params": tp, "opt": OPT.init_state(tp)}
    _, m32 = S.make_train_fn(arch, 2)(state, _tb(batch))
    try:
        S.set_grad_accum_dtype(torch.bfloat16)
        JS.set_grad_accum_dtype(jnp.bfloat16)
        _, m16 = S.make_train_fn(arch, 2)(state, _tb(batch))
        _, jm16 = jax.jit(JS.make_train_fn(jarch, 2))(
            {"params": jp, "opt": JO.init_state(jp)},
            {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        S.set_grad_accum_dtype(torch.float32)
        JS.set_grad_accum_dtype(jnp.float32)
    g32, g16 = (PM.tree_leaves(g) for g in seen)
    assert all(a.dtype == torch.float32 for a in g32)
    assert all(a.dtype == torch.bfloat16 for a in g16)
    assert all(b.dtype == jnp.bfloat16 for b in jax.tree.leaves(jseen[0]))
    for a, b in zip(g16, g32):
        assert torch.equal(a, b.to(torch.bfloat16))
    assert any(not torch.equal(a.float(), b) for a, b in zip(g16, g32))
    np.testing.assert_allclose(m16["loss"].item(), float(jm16["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m16["grad_norm"].item(),
                               float(jm16["grad_norm"]), rtol=2e-2)
    assert m16["grad_norm"].item() != m32["grad_norm"].item()


def _spec_list(tree):
    """(path, shape, dtype name) of every leaf, in sorted-key order."""
    out = []
    for k, leaf in CKPT._flatten(tree):
        dtype = str(leaf.dtype).removeprefix("torch.")
        out.append((k, tuple(leaf.shape), dtype))
    return out


@pytest.mark.parametrize("case", ["train_4k", "prefill_32k", "decode_32k"])
def test_build_cell_equals_reference(case):
    arch, jarch = get_arch("llama3_2_1b"), j_get_arch("llama3_2_1b")
    cell = S.build_cell(arch, arch.shapes[case])
    jcell = JS.build_cell(jarch, jarch.shapes[case])
    assert (cell.name, cell.kind, cell.donate) == \
        (jcell.name, jcell.kind, jcell.donate)
    assert len(cell.args) == len(jcell.args)
    for a, b in zip(cell.args, jcell.args):
        assert all(leaf.device.type == "meta" for _, leaf in
                   CKPT._flatten(a))
        assert _spec_list(a) == _spec_list(b)
    assert callable(cell.fn)


def test_materialize_train_and_unported_families():
    arch = get_arch("llama3_2_1b", True)
    case = ShapeCase("t", "train", batch=2, seq_len=16)
    state, batch = S.materialize(torch.Generator().manual_seed(0), arch,
                                 case, "cpu")
    assert set(state) == {"params", "opt"} and set(batch) == {"tokens",
                                                              "labels"}
    assert batch["tokens"].dtype == torch.int32
    assert torch.equal(batch["labels"], torch.roll(batch["tokens"], -1, 1))
    assert int(state["opt"]["step"]) == 0
    ref = JS.materialize(jax.random.PRNGKey(0), j_get_arch("llama3_2_1b",
                                                            True),
                         JShapeCase("t", "train", batch=2, seq_len=16))
    assert _spec_list(state) == _spec_list(ref[0])
    # the vision and diffusion families are ported (tests/
    # test_torch_zoo_configs.py holds their cells); a family whose model
    # does not take the arch's config raises
    vision = dataclasses.replace(arch, family="vision")
    for call in (lambda: S.make_train_fn(vision),
                 lambda: S.build_cell(vision, case)):
        with pytest.raises(ValueError, match="no vision model takes"):
            call()
    cell = S.build_cell(get_arch("resnet_50", True),
                        ShapeCase("t", "train", batch=2, img_res=32))
    assert set(cell.args[0]) == {"params", "opt", "batch_stats"}


def test_pallas_attention_under_autograd_raises(lm_bf16):
    arch, _, tp, _, batch = lm_bf16
    pallas = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, attention_impl="pallas"))
    with pytest.raises(RuntimeError, match="no backward"):
        S.make_train_fn(pallas)({"params": tp, "opt": OPT.init_state(tp)},
                                _tb(batch))


# ------------------------------------------------------------ detector
def test_detector_fit_steps_match_reference():
    """5 steps of ``serve.fit_step`` against the reference's
    ``value_and_grad`` plus ``apply_updates`` (``examples/train_detector``'s
    streams and optimiser), from the same params and frames."""
    cfg, jcfg = D.TinyDetectorConfig(), JD.TinyDetectorConfig()
    jp = {k: np.asarray(v) for k, v in
          JD.init(jax.random.PRNGKey(0), jcfg).items()}
    params = detector_params_from_jax(jp, "cpu")
    ocfg = dict(lr=3e-3, weight_decay=0.0, warmup_steps=20, total_steps=5)
    jocfg = JO.AdamWConfig(**ocfg)

    @jax.jit
    def jfit(p, opt, frames, boxes, valid):
        loss, g = jax.value_and_grad(lambda q: JD.loss_fn(
            q, jcfg, frames, boxes, valid))(p)
        p, opt, _ = JO.apply_updates(p, g, opt, jocfg)
        return p, opt, loss

    jopt, opt = JO.init_state(jp), OPT.init_state(params)
    streams = [JV.StreamConfig(**{
        f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)})
        for sc in LTD.STREAMS]
    for i in range(5):
        fr, bx, vl = (np.array(a) for a in JV.generate_chunk(
            None, streams[i % 2], i * 4, 4))
        jp, jopt, jl = jfit(jp, jopt, fr, bx, vl)
        params, opt, loss = LS.fit_step(
            params, opt, cfg, OPT.AdamWConfig(**ocfg), torch.from_numpy(fr),
            torch.from_numpy(bx), torch.from_numpy(vl))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    for k, want in detector_params_from_jax(
            {k: np.asarray(v) for k, v in jp.items()}, "cpu").items():
        ref = want.numpy()
        np.testing.assert_allclose(params[k].numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()))


def test_serve_restores_a_reference_checkpoint(tmp_path, monkeypatch):
    """``serve.main --detector-ckpt`` on a checkpoint ``repro`` wrote
    serves exactly ``detector_params_from_jax`` of it, and the quick-train
    (on by default) does not run."""
    jparams = {k: np.asarray(v) for k, v in JD.init(
        jax.random.PRNGKey(6), JD.TinyDetectorConfig()).items()}
    JCKPT.save(str(tmp_path), 3, {k: v * 0 for k, v in jparams.items()})
    JCKPT.save(str(tmp_path), 7, jparams)
    served = []

    class Runtime(LS.EdgeRuntime):
        def __init__(self, cfg, params, det_cfg, **kw):
            served.append(params)
            super().__init__(cfg, params, det_cfg, **kw)

    def no_quick_train(*a, **k):
        raise AssertionError("quick-train ran after a restore")

    monkeypatch.setattr(LS, "EdgeRuntime", Runtime)
    monkeypatch.setattr(LS, "quick_train", no_quick_train)
    out = LS.main(["--streams", "2", "--chunks", "1", "--detector-ckpt",
                   str(tmp_path)], device="cpu")
    assert len(out["f1"]) == 2
    want = detector_params_from_jax(jparams, "cpu")
    assert served[0].keys() == want.keys()
    for k in want:
        assert torch.equal(served[0][k], want[k]), k


# ---------------------------------------------------------- launchers
def test_launch_train_writes_its_steps(tmp_path, capsys):
    d = str(tmp_path / "lm")
    hist = LT.main(["--arch", "llama3_2_1b", "--steps", "4", "--ckpt-dir", d,
                    "--log-every", "2"], device="cpu")
    assert [m["step"] for m in hist] == [2, 4]
    assert all(np.isfinite(m["loss"]) for m in hist)
    assert CKPT.all_steps(d) == [2, 4]
    assert "done: 2 log points" in capsys.readouterr().out
    # resume: the loop starts at step 4
    hist = LT.main(["--arch", "llama3_2_1b", "--steps", "6", "--ckpt-dir", d,
                    "--log-every", "1"], device="cpu")
    assert [m["step"] for m in hist] == [5, 6]
    assert CKPT.all_steps(d) == [2, 4, 6]


def test_launch_train_detector_writes_reference_checkpoints(tmp_path):
    d = str(tmp_path / "det")
    out = LTD.main(["--steps", "4", "--eval-every", "2", "--ckpt-dir", d],
                   device="cpu")
    assert out["steps"] == [2, 4] and len(out["f1"]) == 2
    assert all(0.0 <= f <= 1.0 for f in out["f1"])
    like = {k: np.asarray(v) for k, v in JD.init(
        jax.random.PRNGKey(0), JD.TinyDetectorConfig()).items()}
    back = JCKPT.restore(d, 4, like)
    for k, t in detector_params_from_jax(
            {k: np.asarray(v) for k, v in back.items()}, "cpu").items():
        assert torch.equal(t, out["params"][k]), k


def test_launchers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    for call in (lambda: LT.main(["--arch", "llama3_2_1b", "--steps", "1"]),
                 lambda: LTD.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ------------------------------------------------------------ grad guard
def _guard_calls(g):
    """Each kernel wrapper with its tensor arguments (the first float one
    is the one that may require grad)."""
    r = torch.rand
    dmat = torch.eye(8)
    qtab = torch.full((8, 8), 4.0)
    mv = torch.zeros((1, 2, 2, 2), dtype=torch.int32)
    idx = torch.zeros((1, 2), dtype=torch.int32)
    return {
        "flash_attention": (lambda x: flash_attention(
            x, x, x, causal=True), r(1, 8, 2, 16, generator=g)),
        "motion_sad": (lambda x: motion_sad(x, x, 2),
                       r(32, 32, generator=g) * 255),
        "blockdct.forward_quant": (lambda x: blockdct_ops.forward_quant(
            x, dmat, qtab), r(3, 8, 8, generator=g) * 255),
        "blockdct.forward_quant_raster": (
            lambda x: blockdct_ops.forward_quant_raster(x, dmat, qtab),
            r(2, 16, 16, generator=g) * 255),
        "blockdct.inverse": (lambda x: blockdct_ops.inverse(x, dmat, qtab),
                             r(3, 8, 8, generator=g)),
        "blockdct.inverse_raster": (
            lambda x: blockdct_ops.inverse_raster(x, dmat, qtab, 16, 16),
            r(2, 4, 8, 8, generator=g)),
        "qtransfer": (lambda x: qtransfer(x, mv, x), r(1, 32, 32,
                                                       generator=g)),
        "roi_gather": (lambda x: roi_gather(x, idx, idx, region_px=8,
                                            halo=2), r(1, 20, 20,
                                                       generator=g)),
        "seq_sum": (seq_sum, r(2, 3, 4, generator=g)),
    }


@pytest.mark.parametrize("name", sorted(_guard_calls(None)))
def test_kernel_wrappers_refuse_autograd(name):
    """Under grad with an argument that requires grad every wrapper
    raises, on the CPU as on the card; detached, or under no_grad, it
    runs."""
    call, x = _guard_calls(torch.Generator().manual_seed(0))[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(x.clone().requires_grad_())
    call(x)
    with torch.no_grad():
        call(x.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="no backward"):
        build.refuse_grad(name, None, x.clone().requires_grad_())


def test_training_modules_import_neither_jax_nor_repro():
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.train.checkpoint, repro_torch.train.loop, "
            "repro_torch.train.fault_tolerance, "
            "repro_torch.train.compression, repro_torch.launch.train, "
            "repro_torch.launch.train_detector\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=src))
    assert res.returncode == 0, res.stderr
