"""The port's bi-level trainer on the CPU: the stacked ``run_chunk`` path
against the per-stream loop ``run_chunk_loop``, bit for bit (C = 1, 3, 8;
across a controller interval; with the SAC update engaged; a mode switch
that flushes; the forecast on; seeded determinism; the detector backend);
one run against ``repro.core.bilevel.BiLevelTrainer`` on the same frames,
noise and initial weights; and the baseline policies against the JAX
package's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import policies as JP
from repro.core import bilevel as JBL
from repro.core.classification import classify_frames as j_classify
from repro.sim import env as JE
from repro.sim import video_source as JV
from repro_torch.baselines import policies as P
from repro_torch.core.bilevel import BiLevelTrainer
from repro_torch.core.forecast import ForecastConfig, forecast_dim
from repro_torch.models import detection as D
from repro_torch.models.params import tree_leaves
from repro_torch.models.weights import a2c_stack_from_jax, sac_agent_from_jax
from repro_torch.sim.env import EnvConfig, high_state_dim
from repro_torch.sim.video_source import paper_stream_mix

f32 = np.float32
HH, WW, T = 64, 96, 4


def _tree_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _mk_trainer(C, seed=0, low_batch=4, detector=None, sac_minibatch=None,
                **cfg_kwargs):
    cfg_kwargs.setdefault("chunk_frames", T)
    cfg = EnvConfig(streams=tuple(paper_stream_mix(C, HH, WW)), **cfg_kwargs)
    tr = BiLevelTrainer.create(cfg, seed=seed, detector=detector,
                               low_batch=low_batch, device="cpu")
    if sac_minibatch is not None:   # paper minibatch 128 needs 128 chunks
        tr.controller.cfg = dataclasses.replace(tr.controller.cfg,
                                                minibatch=sac_minibatch)
    return tr


def _run(tr, n, mode):
    hist, logs = [], []
    step = tr.run_chunk if mode == "stacked" else tr.run_chunk_loop
    for _ in range(n):
        m, _, _, lg = step()
        hist.append(m)
        logs.append(lg)
    if mode == "stacked":
        tr.flush()
    return hist, logs


def _hold_trainers(t_loop, t_stack):
    for name in ("s", "a", "r", "s2"):            # replay = full history
        np.testing.assert_array_equal(getattr(t_loop.low_buffer, name),
                                      getattr(t_stack.low_buffer, name), name)
    assert _tree_equal(t_loop.low_stack, t_stack.low_stack)
    assert _tree_equal(t_loop.controller.agent, t_stack.controller.agent)
    np.testing.assert_array_equal(t_loop.controller.buffer.s,
                                  t_stack.controller.buffer.s)
    np.testing.assert_array_equal(t_loop.controller._current,
                                  t_stack.controller._current)


# --------------------------------------------- stacked == loop, exactly
@pytest.mark.parametrize("C", [1, 3, 8])
def test_bilevel_stacked_vs_loop_bit_exact(C):
    """Every action, state and reward written to replay (low_batch=4
    engages the A2C update from chunk 4), the chunk metrics, and every
    parameter after the flush."""
    t_loop, t_stack = _mk_trainer(C), _mk_trainer(C)
    h_loop, _ = _run(t_loop, 6, "loop")
    h_stack, _ = _run(t_stack, 6, "stacked")
    assert h_loop == h_stack
    _hold_trainers(t_loop, t_stack)


def test_bilevel_parity_across_controller_interval():
    """controller_interval=3: the proportions are recomputed at t=0 and
    t=3 of a 5-chunk run and cached in between."""
    t_loop = _mk_trainer(2, controller_interval=3)
    t_stack = _mk_trainer(2, controller_interval=3)
    h_loop, _ = _run(t_loop, 5, "loop")
    h_stack, _ = _run(t_stack, 5, "stacked")
    assert h_loop == h_stack
    _hold_trainers(t_loop, t_stack)


def test_bilevel_parity_with_sac_update_engaged():
    """With the controller's minibatch at 6 the SAC update engages at
    chunk 5 of 8; the stacked path's deferred update, its noise and the
    controller buffer's sampling order equal the loop's."""
    t_loop = _mk_trainer(2, sac_minibatch=6)
    t_stack = _mk_trainer(2, sac_minibatch=6)
    h_loop, l_loop = _run(t_loop, 8, "loop")
    h_stack, l_stack = _run(t_stack, 8, "stacked")
    assert t_loop.controller.updates >= 2
    assert t_loop.controller.updates == t_stack.controller.updates
    assert h_loop == h_stack
    _hold_trainers(t_loop, t_stack)
    # the SAC logs of chunk t's update: in chunk t's loop logs, in chunk
    # t+1's stacked logs
    assert [lg.get("high") for lg in l_loop[:-1]] \
        == [lg.get("high") for lg in l_stack[1:]]


def test_bilevel_mode_mixing_flushes_pending():
    """Switching stacked -> loop on one trainer applies the deferred
    update first, so a mixed run equals a pure loop run."""
    t_mixed, t_pure = _mk_trainer(2, seed=3), _mk_trainer(2, seed=3)
    for _ in range(6):
        t_pure.run_chunk_loop()
    for _ in range(5):
        t_mixed.run_chunk()
    assert t_mixed._pending and t_mixed._pending["do_low"]
    t_mixed.run_chunk_loop()
    assert _tree_equal(t_pure.low_stack, t_mixed.low_stack)
    np.testing.assert_array_equal(t_pure.low_buffer.a, t_mixed.low_buffer.a)


def test_bilevel_forecast_widens_state_and_keeps_parity():
    C = 2
    t_loop = _mk_trainer(C, forecast=ForecastConfig())
    t_stack = _mk_trainer(C, forecast=ForecastConfig())
    assert high_state_dim(t_loop.env.cfg) == 6 * C + forecast_dim(C)
    assert t_loop.controller.buffer.s.shape[1] == 6 * C + forecast_dim(C)
    h_loop, _ = _run(t_loop, 6, "loop")
    h_stack, _ = _run(t_stack, 6, "stacked")
    assert h_loop == h_stack
    _hold_trainers(t_loop, t_stack)
    for tr in (t_loop, t_stack):
        assert tr.env.forecaster.t == 6
    assert _mk_trainer(3).env.forecaster is None


def test_bilevel_seeded_determinism():
    a_hist, a_logs = _run(_mk_trainer(3, seed=11), 6, "stacked")
    b_hist, b_logs = _run(_mk_trainer(3, seed=11), 6, "stacked")
    assert a_hist == b_hist
    assert a_logs == b_logs
    c_hist, _ = _run(_mk_trainer(3, seed=12), 6, "stacked")
    assert c_hist != a_hist


def test_bilevel_stacked_vs_loop_detector_backend():
    """The stacked control plane drives the detector env (one
    ``roundtrip_padded_batched`` call for the frame shape) bit for bit
    as the loop does; ``train_steps`` flushes."""
    det_cfg = D.TinyDetectorConfig()
    det = (D.init(torch.Generator().manual_seed(1), det_cfg, device="cpu"),
           det_cfg)
    kw = dict(accuracy_backend="detector", detector=det, low_batch=2)
    t_loop, t_stack = _mk_trainer(2, **kw), _mk_trainer(2, **kw)
    h_loop, _ = _run(t_loop, 3, "loop")
    h_stack = t_stack.train_steps(3)
    assert t_stack._pending is None
    assert h_loop == h_stack
    _hold_trainers(t_loop, t_stack)


def test_control_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from repro_torch.sim.env import MultiStreamEnv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EnvConfig(streams=tuple(paper_stream_mix(2, HH, WW)),
                    chunk_frames=T)
    tr = _mk_trainer(2)
    for call in (lambda: BiLevelTrainer.create(cfg),
                 lambda: MultiStreamEnv(cfg),
                 lambda: a2c_stack_from_jax({"w": np.zeros(2, f32)}),
                 lambda: sac_agent_from_jax({"w": np.zeros(2, f32)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tr.env.device == torch.device("cpu")
    assert all(x.device.type == "cpu" for x in tree_leaves(tr.low_stack))


# ------------------------------------------------ against the reference
class ReferenceNoise:
    """The reference trainer's key schedule (``bilevel.py:146-151`` and
    ``sac.py:67``), drawn with ``jax.random.normal`` in the port's order."""

    def __init__(self, key):
        self.key = key

    def chunk(self, C, M):
        self.key, k_hi, k_tr = jax.random.split(self.key, 3)
        klo = jax.random.split(self.key, C)
        k1, k2 = jax.random.split(k_tr)

        def t(x):
            return torch.from_numpy(np.array(x))

        return (t(jax.random.normal(k_hi, (C,), jnp.float32)),
                t(jnp.stack([jax.random.normal(k, (2,), jnp.float32)
                             for k in klo])),
                (t(jax.random.normal(k1, (M, C), jnp.float32)),
                 t(jax.random.normal(k2, (M, C), jnp.float32))))


def reference_render(env, jstreams):
    """Make ``env`` render the reference's frames of ``jstreams`` (the
    same streams as the reference's StreamConfigs), in its own layout
    (as tests/test_torch_env.py does)."""
    groups = JV.group_by_signature(jstreams)
    T_ = env.cfg.chunk_frames

    def render(t0):
        data = {}
        for ids in groups.values():
            fr, bx, vd = JV.generate_chunk_batched([jstreams[c] for c in ids],
                                                   t0, T_)
            for i, c in enumerate(ids):
                data[c] = (np.asarray(fr[i]), np.asarray(bx[i]),
                           np.asarray(vd[i]))
        out = []
        for ids in env.shape_groups.values():
            n = max(data[c][1].shape[1] for c in ids)
            boxes = np.zeros((len(ids), T_, n, 4), f32)
            valid = np.zeros((len(ids), T_, n), bool)
            for i, c in enumerate(ids):
                k = data[c][1].shape[1]
                boxes[i, :, :k], valid[i, :, :k] = data[c][1], data[c][2]
            frames = np.stack([data[c][0] for c in ids])
            out.append((ids, torch.from_numpy(frames),
                        torch.from_numpy(boxes), torch.from_numpy(valid)))
        return out

    env.render = render


# the reference and the port from the same weights, frames and noise:
# the observation features and the f32 sums differ by rounding, then the
# Adam steps of near-zero gradients may flip (test_torch_rl.py), so the
# actions drift apart: by at most 2.6e-6 over 6 chunks and 2.1e-5 over 8
# at seeds 5-7 on the CPU, held to ACTION_TOL; the metrics, made from the
# frame types, the allocation and the F1 model, moved by at most 1.8e-7
ACTION_TOL = 1e-4
METRIC_TOL = 1e-5


def test_bilevel_trainer_matches_reference():
    """C=2, analytic backend, 6 chunks of ``run_chunk``, the A2C update
    (low_batch 4) and the SAC update (minibatch 4) both engaged; then
    ``flush``.  Proportions and thresholds within ACTION_TOL every chunk;
    metrics within METRIC_TOL on every chunk whose frame types agree,
    and where a type differs, the feature that decided it within
    ACTION_TOL of its threshold (a rounding flip at Eq. 3's threshold)."""
    C, n = 2, 6
    jcfg = JE.EnvConfig(streams=tuple(JV.paper_stream_mix(C, HH, WW)),
                        chunk_frames=T)
    jtr = JBL.BiLevelTrainer.create(jcfg, seed=5, low_batch=4)
    jtr.controller.cfg = dataclasses.replace(jtr.controller.cfg, minibatch=4)
    tr = _mk_trainer(C, seed=5, sac_minibatch=4)
    tr.low_stack = a2c_stack_from_jax(jax.tree.map(np.asarray, jtr.low_stack),
                                      device="cpu")
    tr.controller.agent = sac_agent_from_jax(
        jax.tree.map(np.asarray, jtr.controller.agent), device="cpu")
    tr.noise = ReferenceNoise(jtr.key)
    reference_render(tr.env, jcfg.streams)
    for t in range(n):
        m, res, _, logs = tr.run_chunk()
        jm, jres, _, jlogs = jtr.run_chunk()
        assert set(logs) == set(jlogs)
        np.testing.assert_allclose(tr.controller._current,
                                   jtr.controller._current, rtol=0,
                                   atol=ACTION_TOL)
        np.testing.assert_allclose(tr.low_buffer.a[:, t],
                                   jtr.low_buffer.a[:, t], rtol=0,
                                   atol=ACTION_TOL)
        same = all(np.array_equal(r["types"], jr["types"])
                   for r, jr in zip(res, jres))
        if same:
            for k in jm:
                assert m[k] == pytest.approx(jm[k], rel=METRIC_TOL,
                                             abs=METRIC_TOL), (t, k)
            continue
        for c, (r, jr) in enumerate(zip(res, jres)):
            if np.array_equal(r["types"], jr["types"]):
                continue
            frames = np.asarray(JV.generate_chunk_batched(
                [jcfg.streams[c]], t * T, T)[0][0])
            _, fd = jtr.env._low_features(frames)
            thr = jtr.low_buffer.a[c, t] * np.asarray(JBL.THRESHOLD_SCALE)
            _, X, R = j_classify(jnp.asarray(fd), jnp.asarray(fd * 0.8 + 0.02),
                                 float(thr[0]), float(thr[1]))
            i = int(np.nonzero(r["types"] != jr["types"])[0][0])
            gap = min(abs(float(X[i]) - thr[0]), abs(float(R[i]) - thr[1]))
            assert gap <= ACTION_TOL, (t, c, i, gap)
    assert tr.controller.updates == jtr.controller.updates >= 1
    assert any(k.startswith("low") for k in logs)
    logs, jlogs = tr.flush(), jtr.flush()
    assert set(logs) == set(jlogs)


# ---------------------------------------------------------------- baselines
@pytest.mark.parametrize("bw", [900.0, 6000.0])
def test_baselines_match_reference(bw):
    """Each of the four policies on the same frames and bandwidth: the
    same decisions (counts exactly), floats within 1e-6 relative."""
    for sc in JV.paper_stream_mix(2, HH, WW):
        fr, bx, vd = (np.array(a) for a in
                      JV.generate_chunk(None, sc, 0, 8))
        for name, run in P.BASELINES.items():
            ours = run(torch.from_numpy(fr), torch.from_numpy(bx),
                       torch.from_numpy(vd), bw, sc)
            ref = JP.BASELINES[name](fr, bx, vd, bw, sc)
            assert set(ours) == set(ref)
            for k, v in ref.items():
                if isinstance(v, str) or isinstance(v, (int, np.integer)):
                    assert ours[k] == v, (name, k)
                else:
                    assert ours[k] == pytest.approx(v, rel=1e-6), (name, k)
