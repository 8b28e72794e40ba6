"""The port's chaos harness on the CPU against the JAX package: the fault
schedules, the named presets and the churn generator answer every query
as the reference's; ``run_soak`` over every preset, chunk-sequential and
with ``batch_submit``, and with the predictive gate (``forecast=``),
reports what the reference reports in every host-decided field, on the
reference's frames (the port module's ``generate_chunk`` replaced) with
its detector weights carried across.

Contract: the fps series, stream stats (events included), recovery
verdicts, fault logs, final shards, hedges, holds and queue leaks
exactly; the forecaster's state within rtol 1e-5 (it tracks the chunks'
bits, f32 sums in another order); wall time not compared."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.forecast import ForecastConfig as JForecastConfig
from repro.models import detection as JD
from repro.serving import faults as JF
from repro.sim import video_source as JV
from repro_torch.core.forecast import ForecastConfig
from repro_torch.models.weights import detector_params_from_jax
from repro_torch.serving import faults as F

N_CHUNKS = 12
SEED = 7
EXACT = ("config", "n_chunks", "stream_stats", "accounting_ok",
         "queue_leaks", "recovery", "recovery_infer", "fault_log",
         "active_shards_final", "hedged_dispatches", "forecast_holds")
SERIES = ("delivered_fps", "infer_fps", "fps_norm", "infer_norm")


def _schedules(n_streams=3, n_shards=2):
    out = [(name, F.preset_schedule(name, n_chunks=N_CHUNKS,
                                    n_streams=n_streams, n_shards=n_shards,
                                    seed=SEED),
            JF.preset_schedule(name, n_chunks=N_CHUNKS, n_streams=n_streams,
                               n_shards=n_shards, seed=SEED))
           for name in F.PRESETS]
    for seed in (0, 5):
        kw = dict(seed=seed, join_frac=0.3, leave_frac=0.3, stall_frac=0.1)
        out.append((f"churn{seed}", F.churn_schedule(N_CHUNKS, 16, **kw),
                    JF.churn_schedule(N_CHUNKS, 16, **kw)))
    return out


def test_presets_and_churn_answer_every_query_as_the_reference():
    assert F.PRESETS == JF.PRESETS and F.FAULT_KINDS == JF.FAULT_KINDS
    for name, s, js in _schedules():
        assert [dataclasses.astuple(e) for e in s.events] == \
            [dataclasses.astuple(e) for e in js.events], name
        assert s.horizon() == js.horizon()
        np.testing.assert_array_equal(s.bw_multipliers(N_CHUNKS + 2),
                                      js.bw_multipliers(N_CHUNKS + 2))
        np.testing.assert_array_equal(s.disruption_mask(N_CHUNKS),
                                      js.disruption_mask(N_CHUNKS))
        for t in range(N_CHUNKS + 1):
            np.testing.assert_array_equal(s.active_mask(t, 16),
                                          js.active_mask(t, 16))
            for c in range(16):
                assert (s.stalled(c, t), s.chunk_lost(c, t),
                        s.chunk_corrupt(c, t),
                        [s.retry_succeeds(c, t, a) for a in range(3)]) == \
                    (js.stalled(c, t), js.chunk_lost(c, t),
                     js.chunk_corrupt(c, t),
                     [js.retry_succeeds(c, t, a) for a in range(3)]), \
                    (name, c, t)
            for g in range(3):
                assert s.shard_slowdown(g, t) == js.shard_slowdown(g, t)


def test_schedule_validation_matches_reference():
    for kw in (dict(kind="meteor", t0=0, t1=1), dict(kind="outage", t0=3,
                                                     t1=2),
               dict(kind="outage", t0=0, t1=1, magnitude=-1.0)):
        with pytest.raises(ValueError):
            JF.FaultEvent(**kw)
        with pytest.raises(ValueError):
            F.FaultEvent(**kw)
    for mod in (F, JF):
        with pytest.raises(ValueError, match="n_chunks >= 12"):
            mod.preset_schedule("loss-burst", n_chunks=8)
        with pytest.raises(KeyError):
            mod.preset_schedule("meteor", n_chunks=12)
        with pytest.raises(ValueError, match="n_chunks >= 4"):
            mod.churn_schedule(3, 4)


@pytest.fixture(scope="module")
def detectors():
    jparams = {k: np.asarray(v) for k, v in
               JD.init(jax.random.PRNGKey(SEED + 1),
                       JD.TinyDetectorConfig()).items()}
    return jparams, detector_params_from_jax(jparams, "cpu")


def _reference_frames(cfg, t0, n, *, device=None):
    """The port's ``generate_chunk`` replaced by the reference's frames of
    the same stream."""
    jcfg = JV.StreamConfig(**dataclasses.asdict(cfg))
    return tuple(torch.from_numpy(np.array(a)).to(device)
                 for a in JV.generate_chunk(None, jcfg, t0, n))


def _soaks(detectors, name, forecast=False, **kw):
    n_shards = 2 if name == "shard-chaos" else 1
    cfg = dict(n_chunks=N_CHUNKS, n_streams=3, chunk_frames=4,
               n_shards=n_shards, seed=SEED)
    fkw = {}
    if forecast:
        fkw = dict(forecast=ForecastConfig())
    jfkw = {k: JForecastConfig() for k in fkw}
    jparams, params = detectors
    ours = F.run_soak(F.SoakConfig(**cfg), F.preset_schedule(
        name, n_chunks=N_CHUNKS, n_shards=n_shards, seed=SEED),
        detector=params, device="cpu", **fkw, **kw)
    ref = JF.run_soak(JF.SoakConfig(**cfg), JF.preset_schedule(
        name, n_chunks=N_CHUNKS, n_shards=n_shards, seed=SEED),
        detector=jparams, **jfkw, **kw)
    return ours, ref


def _hold_reports(ours, ref):
    assert set(ours) == set(ref)
    for k in EXACT:
        assert ours[k] == ref[k], k
    for k in SERIES:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    if ref["forecast_state"] is None:
        assert ours["forecast_state"] is None
    else:
        for k, v in ref["forecast_state"].items():
            np.testing.assert_allclose(ours["forecast_state"][k], v,
                                       rtol=1e-5, err_msg=k)
    assert ours["accounting_ok"] and not ours["queue_leaks"]


@pytest.mark.parametrize("batch_submit", [False, True],
                         ids=["sync", "batch_submit"])
@pytest.mark.parametrize("name", F.PRESETS)
def test_soak_matches_reference(detectors, monkeypatch, name, batch_submit):
    monkeypatch.setattr(F, "generate_chunk", _reference_frames)
    ours, ref = _soaks(detectors, name, batch_submit=batch_submit)
    _hold_reports(ours, ref)
    if name == "shard-chaos":
        assert [a for _, a, _ in ours["fault_log"]] == ["evict", "recover"]


@pytest.mark.parametrize("batch_submit", [False, True],
                         ids=["sync", "batch_submit"])
def test_soak_with_forecast_matches_reference(detectors, monkeypatch,
                                              batch_submit):
    """The predictive gate under the bandwidth collapse: it holds chunks
    (pipeline-③ on the carry) exactly where the reference's does."""
    monkeypatch.setattr(F, "generate_chunk", _reference_frames)
    ours, ref = _soaks(detectors, "bw-collapse", forecast=True,
                       batch_submit=batch_submit)
    _hold_reports(ours, ref)
    assert ours["forecast_holds"] > 0


def test_soak_on_the_ports_own_frames_keeps_its_invariants(detectors):
    """Without the reference's frames (the port's own generator): every
    stream's accounting holds, no queue leaks, the sync and batch-submit
    soaks decide alike, and the straggler shard is evicted and
    recovered."""
    cfg = F.SoakConfig(n_chunks=N_CHUNKS, n_streams=3, chunk_frames=4,
                       n_shards=2, seed=SEED)
    sched = F.preset_schedule("shard-chaos", n_chunks=N_CHUNKS, n_shards=2,
                              seed=SEED)
    a = F.run_soak(cfg, sched, detector=detectors[1], device="cpu")
    b = F.run_soak(cfg, sched, detector=detectors[1], device="cpu",
                   batch_submit=True)
    for r in (a, b):
        assert r["accounting_ok"] and not r["queue_leaks"]
        assert [x for _, x, _ in r["fault_log"]] == ["evict", "recover"]
    assert a["stream_stats"] == b["stream_stats"]
    np.testing.assert_array_equal(a["delivered_fps"], b["delivered_fps"])
