"""The port's environment on the CPU: the bandwidth traces, the forecaster,
the scheduler and the edge config equal to the JAX package's; env steps
with the analytic and the detector backends (and a fault schedule) on the
reference's frames against ``repro.sim.env``; and the detector backend's
one call for a frame shape against one call for each signature group."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import biswift_edge as JB
from repro.core import forecast as JFC
from repro.models import detection as JD
from repro.serving import faults as JFLT
from repro.serving import scheduler as JSCH
from repro.sim import env as JE
from repro.sim import network as JNW
from repro.sim import video_source as JV
from repro_torch.configs import biswift_edge as B
from repro_torch.core import forecast as FC
from repro_torch.core.roundtrip import (_downscale_pad, full_lr_canvas,
                                        ladder_batch_arrays,
                                        roundtrip_padded_batched)
from repro_torch.models import detection as D
from repro_torch.models.weights import detector_params_from_jax
from repro_torch.serving import faults as FLT
from repro_torch.serving import scheduler as SCH
from repro_torch.sim import env as E
from repro_torch.sim import network as NW
from repro_torch.sim import video_source as V

f32 = np.float32
HH, WW, T = 64, 96, 4
# the observation features: f32 means over the frames in another order
# than numpy's
OBS = dict(rtol=1e-5, atol=1e-6)


def reference_render(env, jstreams):
    """Make ``env`` render the reference's frames of ``jstreams`` (the
    same streams as the reference's StreamConfigs), in its own layout."""
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


def _configs(C, **kw):
    jcfg = JE.EnvConfig(streams=tuple(JV.paper_stream_mix(C, HH, WW)),
                        chunk_frames=T, **kw)
    cfg = E.EnvConfig(streams=tuple(V.paper_stream_mix(C, HH, WW)),
                      chunk_frames=T, **kw)
    return jcfg, cfg


# ------------------------------------------------------ numpy copies
def test_traces_allocation_and_forecaster_equal_reference():
    for tc in (NW.TraceConfig(), NW.TraceConfig(mean_kbps=8000.0, ar=0.5,
                                                 seed=3)):
        jtc = JNW.TraceConfig(**dataclasses.asdict(tc))
        np.testing.assert_array_equal(NW.generate_trace(tc, 5000),
                                      JNW.generate_trace(jtc, 5000))
        np.testing.assert_array_equal(NW.generate_trace_loop(tc, 300),
                                      JNW.generate_trace_loop(jtc, 300))
    trace = NW.generate_trace(NW.TraceConfig(), 50)
    mult = np.linspace(0.0, 2.0, 50)
    np.testing.assert_array_equal(NW.apply_fault_profile(trace, mult),
                                  JNW.apply_fault_profile(trace, mult))
    props = np.array([0.5, 0.2, 0.0, 0.3])
    np.testing.assert_array_equal(NW.allocate(9000.0, props),
                                  JNW.allocate(9000.0, props))
    np.testing.assert_array_equal(NW.even_allocation(9000.0, 4),
                                  JNW.even_allocation(9000.0, 4))
    fc = FC.StreamForecaster(FC.ForecastConfig(), 3)
    jfc = JFC.StreamForecaster(JFC.ForecastConfig(), 3)
    rng = np.random.default_rng(0)
    for t in range(12):
        bw, bits = rng.uniform(500, 9000, 3), rng.uniform(1e4, 1e5, 3)
        mask = rng.uniform(size=3) > 0.2
        fc.update(bw, bits, mask)
        jfc.update(bw, bits, mask)
        np.testing.assert_array_equal(fc.features(), jfc.features())
        np.testing.assert_array_equal(fc.predict_bw(), jfc.predict_bw())
    assert FC.forecast_dim(5) == JFC.forecast_dim(5)


def test_scheduler_and_edge_config_equal_reference():
    cfg, env, serving = B.build(9, 720, 1280)
    jcfg, jenv, jserving = JB.build(9, 720, 1280)
    assert dataclasses.asdict(cfg.costs) == dataclasses.asdict(jcfg.costs)
    assert dataclasses.asdict(cfg.detector) \
        == dataclasses.asdict(jcfg.detector)
    for f in dataclasses.fields(cfg):
        if f.name not in ("costs", "detector"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for f in dataclasses.fields(env):
        if f.name == "streams":
            assert [dataclasses.asdict(s) for s in env.streams] \
                == [dataclasses.asdict(s) for s in jenv.streams]
        elif f.name == "trace":
            assert dataclasses.asdict(env.trace) \
                == dataclasses.asdict(jenv.trace)
        else:
            assert getattr(env, f.name) == getattr(jenv, f.name), f.name
    assert dataclasses.asdict(serving) == dataclasses.asdict(jserving)
    assert E.low_state_dim(env) == JE.low_state_dim(jenv)
    assert E.low_alloc_offset(env) == JE.low_alloc_offset(jenv)
    assert E.high_state_dim(env) == JE.high_state_dim(jenv)

    # the queues, the admission and the fused drain, fed the same requests
    scfg = SCH.ServingConfig(n_streams=3, batch_size=4, n_shards=2)
    jscfg = JSCH.ServingConfig(n_streams=3, batch_size=4, n_shards=2)

    def infer(frames):
        return [float(f.sum()) for f in frames]

    q, jq = SCH.PipelineQueues(scfg, infer), JSCH.PipelineQueues(jscfg, infer)
    rng = np.random.default_rng(1)
    for i in range(7):
        frame = rng.normal(size=(2, 3)).astype(f32)
        for queue, mod in ((q, SCH), (jq, JSCH)):
            queue.submit(mod.InferRequest(stream=i % 3, chunk_t=0,
                                          frame_idx=i, pipeline=1 + i % 2,
                                          frame=frame, shard=i % 2))
    np.testing.assert_array_equal(q.depths, jq.depths)
    np.testing.assert_array_equal(q.shard_depths, jq.shard_depths)
    adm, jadm = SCH.AdmissionController(scfg), JSCH.AdmissionController(jscfg)
    for n in (0, 50, 200):
        assert adm.admit(q.depths, n) == jadm.admit(jq.depths, n)
        assert adm.admit_shard(q.shard_depths, 1, n) \
            == jadm.admit_shard(jq.shard_depths, 1, n)
    got, want = q.drain_fused(shard=0), jq.drain_fused(shard=0)
    assert [(r.frame_idx, o) for r, o in got] \
        == [(r.frame_idx, o) for r, o in want]
    assert [(r.frame_idx, o) for r, o in q.drain(max_frames=3)] \
        == [(r.frame_idx, o) for r, o in jq.drain(max_frames=3)]


# ------------------------------------------------------------- env steps
def _hold_results(ours, ref, float_tol):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert set(o) == set(r)
        np.testing.assert_array_equal(o["types"], r["types"])
        for k, v in r.items():
            if k == "types":
                continue
            if isinstance(v, (bool, np.bool_, int, np.integer)):
                assert o[k] == v, k
            else:
                np.testing.assert_allclose(o[k], v, **float_tol.get(
                    k, OBS), err_msg=k)


def _analytic_run(jcfg, cfg, faults=None, jfaults=None, steps=3):
    jenv = JE.MultiStreamEnv(jcfg, faults=jfaults)
    env = E.MultiStreamEnv(cfg, faults=faults, device="cpu")
    reference_render(env, jcfg.streams)
    C = len(cfg.streams)
    rng = np.random.default_rng(4)
    for step in range(steps):
        np.testing.assert_allclose(env.observe_high(), jenv.observe_high(),
                                   **OBS)
        props = rng.dirichlet(np.ones(C)).astype(f32)
        np.testing.assert_allclose(env.observe_low_batched(props),
                                   jenv.observe_low_batched(props), **OBS)
        np.testing.assert_array_equal(env.observe_low_batched(props)[1],
                                      env.observe_low(1, props))
        # thresholds in the features' range, clear of any rounding flip
        thr = (rng.uniform(0.0, 0.25, (C, 2)) + 0.013).astype(f32)
        res, info = env.step(props, thr)
        jres, jinfo = jenv.step(props, thr)
        _hold_results(res, jres, {})
        for k in ("active_mask", "stalled_mask", "alloc"):
            np.testing.assert_array_equal(info[k], jinfo[k], k)
        for k in ("total_bw", "queue_delay"):
            assert info[k] == pytest.approx(jinfo[k], rel=1e-6), k
    np.testing.assert_array_equal(env.shard_queues, jenv.shard_queues)
    return env, jenv


@pytest.mark.parametrize("C,n_shards", [(3, 1), (4, 2)])
def test_analytic_env_step_matches_jax(C, n_shards):
    """Three analytic steps from the same frames, proportions and
    thresholds: states within ``OBS``, result rows within it too (frame
    types and counts exactly)."""
    jcfg, cfg = _configs(C, n_shards=n_shards,
                         forecast=FC.ForecastConfig() if C == 4 else None)
    if C == 4:
        jcfg = dataclasses.replace(jcfg, forecast=JFC.ForecastConfig())
    env, jenv = _analytic_run(jcfg, cfg)
    assert env.observe_high().shape == (E.high_state_dim(cfg),)


def test_analytic_env_step_with_faults_matches_jax():
    """One reference fault schedule passed to both envs (the port duck
    types it): a bandwidth collapse, a stream leaving and a stall."""
    events = [JFLT.FaultEvent("bw_collapse", 1, 2, magnitude=0.2),
              JFLT.FaultEvent("leave", 1, 3, target=1),
              JFLT.FaultEvent("stall", 2, 3, target=0)]
    sched = JFLT.FaultSchedule(events, seed=0)
    jcfg, cfg = _configs(3)
    env, _ = _analytic_run(jcfg, cfg, faults=sched, jfaults=sched)
    assert env.t == 3


def test_analytic_env_step_with_the_ports_fault_schedule_matches_jax():
    """The port's own FaultSchedule drives the port's env, the
    reference's schedule of the same events the reference env: a
    collapse, a stream leaving, a stall and a chunk-loss window."""
    events = [("bw_collapse", 1, 2, -1, 0.2), ("leave", 1, 3, 1, 1.0),
              ("stall", 2, 3, 0, 1.0), ("chunk_loss", 0, 3, 2, 0.5)]
    sched = FLT.FaultSchedule([FLT.FaultEvent(*e) for e in events], seed=3)
    jsched = JFLT.FaultSchedule([JFLT.FaultEvent(*e) for e in events],
                                seed=3)
    jcfg, cfg = _configs(3)
    env, _ = _analytic_run(jcfg, cfg, faults=sched, jfaults=jsched)
    assert env.t == 3 and isinstance(env.faults, FLT.FaultSchedule)


@pytest.fixture(scope="module")
def detector():
    det_cfg = JD.TinyDetectorConfig()
    jparams = {k: np.asarray(v) for k, v in
               JD.init(jax.random.PRNGKey(1), det_cfg).items()}
    return (jparams, det_cfg), (detector_params_from_jax(jparams, "cpu"),
                                D.TinyDetectorConfig())


def test_detector_env_step_matches_jax(detector):
    """Two detector-backend steps of 2 streams (two signature groups: the
    reference makes a call for each, the port one for the frame shape),
    the detector weights carried across: types exact, the floats under
    the round trip's contract (tests/test_torch_roundtrip.py)."""
    jdet, det = detector
    jcfg, cfg = _configs(2, accuracy_backend="detector")
    jenv = JE.MultiStreamEnv(jcfg, detector=jdet)
    env = E.MultiStreamEnv(cfg, detector=det, device="cpu")
    reference_render(env, jcfg.streams)
    tol = {"accuracy": dict(rtol=0, atol=1e-6),
           "bits": dict(rtol=1e-4, atol=0),
           "utilization": dict(rtol=1e-4, atol=0),
           **{k: dict(rtol=1e-5, atol=0)
              for k in ("latency", "t_trans", "t_comp", "queue_delay",
                        "reward")}}
    mix = np.zeros(3, int)
    for thr in ([[0.05, 0.1], [0.5, 0.02]], [[0.5, 0.02], [0.02, 0.3]]):
        props = np.array([0.7, 0.3], f32)
        thr = np.asarray(thr, f32)
        res, _ = env.step(props, thr)
        jres, _ = jenv.step(props, thr)
        _hold_results(res, jres, tol)
        for r in res:
            mix += [np.sum(r["types"] == k) for k in (1, 2, 3)]
    assert (mix > 0).all(), mix           # every pipeline ran
    np.testing.assert_allclose(env.observe_high(), jenv.observe_high(),
                               **OBS)


def test_one_call_a_shape_equals_one_call_a_signature(detector):
    """The env's merged call (the ground truth padded to the densest
    stream's count, the pad invalid) against one call for each signature
    group on its own ground truth: every lane bit for bit."""
    _, (params, det_cfg) = detector
    _, cfg = _configs(3, accuracy_backend="detector")
    env = E.MultiStreamEnv(cfg, detector=(params, det_cfg), device="cpu")
    ((ids, raw, gtb, gtv),) = env.render(T)
    assert ids == [0, 1, 2] and gtb.shape[2] == 12
    levels = [2, 0, 4]
    kw = dict(tr1=torch.tensor([0.5, 0.05, 0.3]),
              tr2=torch.tensor([0.02, 0.1, 0.05]),
              bw_kbps=torch.tensor([3000.0, 800.0, 9000.0]),
              queue_delay=0.0, cfg=env._roundtrip_cfg(), device="cpu")

    def call(lanes, n):
        ext, qual = ladder_batch_arrays([levels[i] for i in lanes], HH, WW,
                                        device="cpu")
        lr = _downscale_pad(raw[lanes], [levels[i] for i in lanes],
                            full_lr_canvas(HH, WW))
        k = {a: (v[lanes] if torch.is_tensor(v) and v.dim() else v)
             for a, v in kw.items()}
        return roundtrip_padded_batched(raw[lanes], lr, ext, qual,
                                        gtb[lanes, :, :n], gtv[lanes, :, :n],
                                        params, **k)

    merged = call([0, 1, 2], 12)
    for lanes, n in (([0, 2], 3), ([1], 12)):
        alone = call(lanes, n)
        for i, c in enumerate(lanes):
            for k, v in alone.items():
                assert torch.equal(merged[k][c], v[i]), (k, c)
