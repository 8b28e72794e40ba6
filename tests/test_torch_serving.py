"""The serving plane of the port on the CPU against the JAX package: greedy
NMS, the detector's loss and gradient and a few quick-train steps, the
chunk form of the quality transfer, the hybrid encoder, the legacy and
fused decode paths, ``EdgeRuntime`` (carry, submit/flush/poll, the
in-flight cap, ROI mode, the anchor search's rung bits, the legacy drain,
hold, skip, deferral, eviction and recovery) and the serve launcher, on
the reference's frames with its detector and controller weights carried
across; then the new modules' CUDA default and isolation.

Contracts: integer and host-decided outputs (frame types, MVs, rungs,
anchor qualities, NMS picks, stats, fault logs) exactly; the detector's
scores within atol 1e-4 and boxes within 1e-2 px, latency rtol 1e-5 and
F1 atol 1e-6 (``tests/test_torch_roundtrip.py``); bits rtol 1e-6; the
decoded anchors within the blockdct contract, 1e-3 px."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import video_codec as JVC
from repro.core import hybrid_decoder as JH
from repro.core import hybrid_encoder as JE
from repro.core import quality_transfer as JQ
from repro.core.bandwidth_controller import BandwidthController as JBC
from repro.core.roi import RoiConfig as JRoiConfig
from repro.launch import serve as JLS
from repro.models import detection as JD
from repro.serving import faults as JF
from repro.serving import runtime as JR
from repro.serving import scheduler as JSCH
from repro.sim import env as JEnv
from repro.sim import video_source as JV
from repro.train import optimizer as JO
from repro_torch.codec.video_codec import EncodedChunk
from repro_torch.core import hybrid_decoder as H
from repro_torch.core import hybrid_encoder as E
from repro_torch.core import quality_transfer as Q
from repro_torch.core.roi import RoiConfig
from repro_torch.launch import serve as LS
from repro_torch.models import detection as D
from repro_torch.models.weights import (detector_params_from_jax,
                                        sac_agent_from_jax)
from repro_torch.serving import faults as F
from repro_torch.serving import runtime as R
from repro_torch.serving import scheduler as SCH
from repro_torch.sim import env as Env

HH, WW, T = 64, 96, 4
SCORES = dict(rtol=0, atol=1e-4)
BOXES = dict(rtol=0, atol=1e-2)
DET = D.TinyDetectorConfig()
JDET = JD.TinyDetectorConfig()


@pytest.fixture(scope="module")
def weights():
    jparams = {k: np.asarray(v) for k, v in
               JD.init(jax.random.PRNGKey(1), JDET).items()}
    return jparams, detector_params_from_jax(jparams, "cpu")


def _frames(seed=0, t0=0, n_objects=3, H=HH, W=WW):
    fr, bx, vl = JV.generate_chunk(None, JV.StreamConfig(
        height=H, width=W, n_objects=n_objects, seed=seed), t0, T)
    return np.array(fr), np.array(bx), np.array(vl)


def port_packet(jp) -> E.HybridPacket:
    """The reference's packet with its arrays as CPU tensors."""
    enc = EncodedChunk(**{f.name: torch.from_numpy(
        np.array(getattr(jp.video, f.name)))
        for f in dataclasses.fields(EncodedChunk)})
    return E.HybridPacket(
        types=np.array(jp.types), ladder_level=jp.ladder_level, video=enc,
        anchor_hd=torch.from_numpy(np.array(jp.anchor_hd)),
        anchor_quality=jp.anchor_quality, video_bits=jp.video_bits,
        anchor_bits=jp.anchor_bits, lr_shape=jp.lr_shape)


@pytest.fixture(scope="module")
def packets():
    """Reference packets of 3 streams x 3 chunks, each with pipeline ②
    frames (tr1=0.5, tr2=0.02 drive it)."""
    out = {}
    for s in range(3):
        for t in range(3):
            fr, _, _ = _frames(seed=s, t0=t * T)
            out[s, t] = JE.encode_hybrid(fr, 6000.0, 0.5, 0.02)
    assert any((p.types == 2).any() for p in out.values())
    return out


# ------------------------------------------------------------- detection
@pytest.mark.parametrize("top_k,thr", [(8, 0.3), (16, 0.5), (64, 0.4)])
def test_greedy_nms_matches_reference_with_ties(top_k, thr):
    """Scores on a coarse grid (many ties) over 5 frames in one call: the
    picked boxes and the kept scores equal the reference's frame by frame
    (k = min(top_k, N): 64 > N = 40 too)."""
    rng = np.random.default_rng(3)
    boxes = np.concatenate([rng.uniform(0, 60, (5, 40, 2)),
                            rng.uniform(5, 30, (5, 40, 2))], -1)
    boxes = boxes.astype(np.float32)
    scores = (rng.integers(0, 4, (5, 40)) / 4).astype(np.float32)
    bx, sc = D.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          thr, top_k)
    for b in range(5):
        jb, js = JD.greedy_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                               thr, top_k)
        np.testing.assert_array_equal(bx[b].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(sc[b].numpy(), np.asarray(js))


def test_cell_targets_match_reference_exactly():
    """Duplicate box centres (argmin ties: the first box wins), invalid
    boxes, and a frame with none valid."""
    _, bx, vl = _frames(n_objects=4)
    bx[:, 1] = bx[:, 0] * np.array([1, 1, 0.5, 2], np.float32)
    vl[:, 2] = False
    vl[3] = False
    tgt, pos = D._cell_targets(torch.from_numpy(bx), torch.from_numpy(vl),
                               HH // 8, WW // 8, 8)
    targets = jax.jit(JD._cell_targets, static_argnums=(2, 3, 4))
    for t in range(T):
        jt, jp = targets(jnp.asarray(bx[t]), jnp.asarray(vl[t]), HH // 8,
                         WW // 8, 8)
        np.testing.assert_array_equal(tgt[t].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(pos[t].numpy(), np.asarray(jp))


def _close(ours, ref, rtol=1e-4):
    """rtol 1e-4, with an absolute floor of rtol x the largest |ref|."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _grad_ref(g):
    g = np.asarray(g)
    return g.transpose(3, 2, 0, 1) if g.ndim == 4 else g


def test_loss_and_gradient_match_reference(weights):
    jparams, params = weights
    fr, bx, vl = _frames()
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JD.loss_fn(p, JDET, fr, bx, vl)))(jparams)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = D.loss_fn(p, DET, torch.from_numpy(fr), torch.from_numpy(bx),
                     torch.from_numpy(vl))
    grads = torch.autograd.grad(loss, list(p.values()))
    _close(loss.item(), float(jl))
    for k, g in zip(p, grads):
        _close(g.numpy(), _grad_ref(jg[k]))


def test_quick_train_steps_match_reference(weights):
    """Three AdamW steps of serve's inline fit, the reference's jitted
    step against ``serve.fit_step``: losses and parameters within rtol
    1e-4."""
    jparams, params = weights
    ocfg = dict(lr=3e-3, weight_decay=0.0, warmup_steps=10, total_steps=3)
    jocfg = JO.AdamWConfig(**ocfg)

    @jax.jit
    def jfit(p, opt, frames, boxes, valid):
        loss, g = jax.value_and_grad(lambda q: JD.loss_fn(
            q, JDET, frames, boxes, valid))(p)
        p, opt, _ = JO.apply_updates(p, g, opt, jocfg)
        return p, opt, loss

    jp, jopt = jparams, JO.init_state(jparams)
    opt = LS.init_state(params)
    streams = JV.paper_stream_mix(2, HH, WW)
    for i in range(3):
        fr, bx, vl = (np.array(a) for a in JV.generate_chunk(
            None, streams[i % 2], i * 4, 4))
        jp, jopt, jl = jfit(jp, jopt, fr, bx, vl)
        params, opt, loss = LS.fit_step(
            params, opt, DET, LS.AdamWConfig(**ocfg), torch.from_numpy(fr),
            torch.from_numpy(bx), torch.from_numpy(vl))
        _close(loss.item(), float(jl))
    for k in params:
        _close(params[k].numpy(), _grad_ref(jp[k]))


# --------------------------------------------------- quality transfer
def test_transfer_chunk_and_gain_match_reference():
    """A full-resolution encode (the residuals on the HD grid), types with
    every pipeline, each frame's nearest anchor: the transferred frames
    within the blockdct contract, the PSNR gain within rtol 1e-5."""
    fr, _, _ = _frames(seed=1)
    enc = JVC.encode_chunk(fr, JVC.VideoCodecConfig())
    types = np.array([1, 2, 3, 2], np.int32)
    aidx = np.array([0, 0, 0, 0], np.int32)
    anchor = np.repeat(np.array(enc.recon[:1]), T, 0)
    args = [np.array(enc.recon), anchor, aidx, np.array(enc.mv),
            np.array(enc.residual_q), np.array(enc.qtab), types]
    ref = np.asarray(JQ.transfer_chunk(*map(jnp.asarray, args)))
    ours = Q.transfer_chunk(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ours[types != 2].numpy(),
                                  np.array(enc.recon)[types != 2])
    gain = Q.transfer_gain_psnr(torch.from_numpy(fr),
                                torch.from_numpy(args[0]), ours)
    jgain = JQ.transfer_gain_psnr(fr, args[0], ref)
    np.testing.assert_allclose(gain.item(), float(jgain), rtol=1e-5)


# ------------------------------------------------------- hybrid encoder
def _mid_quality_bw(fr, level):
    """A bandwidth at which the first anchor's even share of the leftover
    budget falls between its bits at the 3rd and 4th quality."""
    jp = JE.encode_hybrid(fr, 6000.0, 0.05, 0.1, level=level)
    i = int(np.nonzero(jp.types == 1)[0][0])
    bits = [float(JE._jpeg_bits(jnp.asarray(fr[i]), q))
            for q in JE.ANCHOR_QUALITIES]
    per = 0.5 * (bits[2] + bits[3])
    n = int((jp.types == 1).sum())
    return (per * n + jp.video_bits) / (1000.0 * T / 30.0)


ENCODE_CASES = [
    dict(bw=300.0), dict(bw=8000.0), dict(bw=30000.0, tr=(0.5, 0.02)),
    dict(bw=2000.0, level=0), dict(bw=2000.0, level=4),
    dict(bw="mid", level=2),
    dict(bw=6000.0, overrides={"use_kernel": True}),
    dict(bw=6000.0, overrides={"search": "diamond"}),
    dict(bw=6000.0, overrides={"dtype": "bfloat16"}, seed=2),
]


@pytest.mark.parametrize("case", ENCODE_CASES,
                         ids=lambda c: "-".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_encode_hybrid_matches_reference(case):
    fr, _, _ = _frames(seed=case.get("seed", 0))
    level = case.get("level")
    bw = _mid_quality_bw(fr, level) if case["bw"] == "mid" else case["bw"]
    tr1, tr2 = case.get("tr", (0.05, 0.1))
    kw = dict(level=level, codec_overrides=case.get("overrides"))
    jp = JE.encode_hybrid(fr, bw, tr1, tr2, **kw)
    p = E.encode_hybrid(fr, bw, tr1, tr2, device="cpu", **kw)
    np.testing.assert_array_equal(p.types, np.asarray(jp.types))
    assert p.types.dtype == np.asarray(jp.types).dtype
    assert (p.ladder_level, p.anchor_quality, p.lr_shape) == \
        (jp.ladder_level, jp.anchor_quality, jp.lr_shape)
    np.testing.assert_array_equal(p.video.mv.numpy(), np.asarray(jp.video.mv))
    for k in ("video_bits", "anchor_bits", "total_bits"):
        np.testing.assert_allclose(getattr(p, k), getattr(jp, k), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(p.anchor_hd.numpy(), np.asarray(jp.anchor_hd),
                               rtol=0, atol=1e-3)
    if case["bw"] == "mid":
        assert p.anchor_quality == 55.0


def test_encode_hybrid_rejects_bad_level():
    fr, _, _ = _frames()
    with pytest.raises(ValueError, match="ladder level"):
        E.encode_hybrid(fr, 6000.0, 0.05, 0.1, level=5, device="cpu")


# ------------------------------------------------------- decode paths
def _hold_result(ours, ref):
    np.testing.assert_array_equal(ours.types, ref.types)
    np.testing.assert_allclose(ours.scores, np.asarray(ref.scores), **SCORES)
    np.testing.assert_allclose(ours.boxes, np.asarray(ref.boxes), **BOXES)
    np.testing.assert_allclose(ours.f1, np.asarray(ref.f1), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ours.mean_f1, ref.mean_f1, rtol=0, atol=1e-6)
    for k in ("latency", "t_trans", "t_queue", "t_comp"):
        np.testing.assert_allclose(getattr(ours, k), getattr(ref, k),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("path", ["decode_and_execute",
                                  "decode_and_execute_fused"])
def test_decode_paths_match_reference(weights, packets, path):
    jparams, params = weights
    _, gtb, gtv = _frames(seed=1)
    jp = packets[1, 0]
    kw = dict(bw_kbps=6000.0, queue_delay=0.05)
    ref = getattr(JH, path)(jp, jparams, JDET, gtb, gtv, **kw)
    ours = getattr(H, path)(port_packet(jp), params, DET, gtb, gtv,
                            device="cpu", **kw)
    assert (ours.types == 2).any()
    _hold_result(ours, ref)


# ------------------------------------------------------------- runtime
def _runtimes(weights, faults=None, n_streams=3, **kw):
    """The port's runtime (CPU) and the reference's, one ServingConfig."""
    jparams, params = weights
    jkw = dict(kw)
    if "roi" in kw:
        jkw["roi"] = JRoiConfig(**dataclasses.asdict(kw["roi"]))
    ours = R.EdgeRuntime(SCH.ServingConfig(n_streams=n_streams, **kw),
                         params, DET, faults=faults, device="cpu")
    ref = JR.EdgeRuntime(JSCH.ServingConfig(n_streams=n_streams, **jkw),
                         jparams, JDET, faults=faults)
    return ours, ref


def _hold_poll(ours, ref, where=""):
    b, s, ty = ours
    jb, js, jty = ref
    np.testing.assert_array_equal(ty, jty, err_msg=where)
    np.testing.assert_allclose(s, np.asarray(js), **SCORES, err_msg=where)
    np.testing.assert_allclose(b, np.asarray(jb), **BOXES, err_msg=where)


def _hold_stats(ours, ref):
    assert {c: s.as_dict() for c, s in ours.stats.items()} == \
        {c: s.as_dict() for c, s in ref.stats.items()}
    for s in ours.stats.values():
        assert s.frames_in == s.frames_inferred + s.frames_reused \
            + s.frames_skipped


def test_runtime_process_chunk_carry_matches_reference(weights, packets):
    """Three chunks of three streams through ``process_chunk``: the
    pipeline-③ carry crosses chunk boundaries; every result and the
    stats as the reference's."""
    rt, jrt = _runtimes(weights)
    for t in range(3):
        for s in range(3):
            _hold_poll(rt.process_chunk(s, t, port_packet(packets[s, t])),
                       jrt.process_chunk(s, t, packets[s, t]), f"{s} {t}")
            lat = rt.compute_latency(packets[s, t].types, 1e5, 3000.0, s)
            assert lat == jrt.compute_latency(packets[s, t].types, 1e5,
                                              3000.0, s)
    _hold_stats(rt, jrt)
    rt.close()
    jrt.close()


def test_runtime_submit_flush_poll_out_of_order(weights, packets):
    """A round submitted together, polled in reverse order, equals the
    port's own process_chunk bit for bit and the reference's within the
    contract; a second poll returns the cached result."""
    rt, jrt = _runtimes(weights)
    oracle, _ = _runtimes(weights)
    for t in range(2):
        tks = [rt.submit_chunk(s, t, port_packet(packets[s, t]))
               for s in range(3)]
        assert not any(tk.done for tk in tks)
        assert rt.queues.depths.sum() == sum(len(tk.reqs) for tk in tks)
        outs = {s: rt.poll(tks[s]) for s in reversed(range(3))}
        assert rt.queues.depths.sum() == 0
        for s in range(3):
            ref = oracle.process_chunk(s, t, port_packet(packets[s, t]))
            for a, b in zip(outs[s], ref):
                np.testing.assert_array_equal(a, b)
            assert rt.poll(tks[s]) is outs[s]
            assert tks[s]._dev_out is None
        jtks = [jrt.submit_chunk(s, t, packets[s, t]) for s in range(3)]
        for s, jo in enumerate(jrt.poll_all(jtks)):
            _hold_poll(outs[s], jo)
    _hold_stats(rt, jrt)


def test_runtime_inflight_cap_and_ordering(weights, packets):
    """``max_inflight=1`` bounds the outstanding batches; a stream's next
    submit flushes its pending ticket first; close retires everything."""
    rt, _ = _runtimes(weights, max_inflight=1)
    oracle, _ = _runtimes(weights)
    for t in range(3):
        tks = [rt.submit_chunk(s, t, port_packet(packets[s, t]))
               for s in range(2)]
        rt.flush()
        assert all(len(q) <= 1 for q in rt._inflight.values())
        for s, tk in enumerate(tks):
            np.testing.assert_array_equal(
                rt.poll(tk)[0],
                oracle.process_chunk(s, t, port_packet(packets[s, t]))[0])
    tk0 = rt.submit_chunk(2, 0, port_packet(packets[2, 0]))
    tk1 = rt.submit_chunk(2, 1, port_packet(packets[2, 1]))
    assert tk0.done and not tk1.done
    rt.close()
    assert all(len(q) == 0 for q in rt._inflight.values())
    rt.close()


def test_runtime_roi_mode_matches_reference(weights, packets):
    """ROI-gated dispatch (the top 3 of 6 regions a row) in one
    cross-stream batch a round; the legacy frame-payload drain refuses
    ROI mode."""
    roi = RoiConfig(capacity=3)
    rt, jrt = _runtimes(weights, roi=roi)
    for t in range(2):
        tks = [rt.submit_chunk(s, t, port_packet(packets[s, t]))
               for s in range(3)]
        jtks = [jrt.submit_chunk(s, t, packets[s, t]) for s in range(3)]
        assert tks[0].rscores_dev.shape == (T, 6)
        np.testing.assert_allclose(tks[0].rscores_dev.numpy(),
                                   np.asarray(jtks[0].rscores_dev),
                                   rtol=1e-6)
        for o, jo in zip(rt.poll_all(tks), jrt.poll_all(jtks)):
            _hold_poll(o, jo)
    with pytest.raises(RuntimeError, match="ROI mode"):
        rt._infer_batch(np.zeros((1, HH, WW), np.float32))


def test_runtime_anchor_search_stages_rung_bits(weights, packets):
    """The staged (T, 6) rung bits are ``ladder_bits`` of the anchor plane
    bit for bit, and the reference's within rtol 1e-3: a decoded anchor
    re-encoded puts DCT coefficients on quantisation ties, where the
    transform's summation order may move a level by one (the blockdct
    contract, max|dq| <= 1)."""
    from repro_torch.codec.image_codec import ladder_bits
    rt, jrt = _runtimes(weights, anchor_search=True)
    pk = port_packet(packets[0, 0])
    tk = rt.submit_chunk(0, 0, pk)
    jtk = jrt.submit_chunk(0, 0, packets[0, 0])
    assert tk.rung_bits_dev.shape == (T, 6)
    assert torch.equal(tk.rung_bits_dev, ladder_bits(pk.anchor_hd))
    np.testing.assert_allclose(tk.rung_bits_dev.numpy(),
                               np.asarray(jtk.rung_bits_dev), rtol=1e-3)
    _hold_poll(rt.poll(tk), jrt.poll(jtk))
    assert tk.rung_bits_dev is not None        # kept past the poll


def test_runtime_legacy_drain_fused_matches_reference(weights):
    """``PipelineQueues.drain_fused`` through the runtime's legacy
    executor: padded to the batch size, host rows out."""
    rt, jrt = _runtimes(weights)
    fr, _, _ = _frames(seed=2)
    for q, cls in ((rt.queues, SCH.InferRequest),
                   (jrt.queues, JSCH.InferRequest)):
        for i in range(3):
            q.submit(cls(0, 0, i, 1 + i % 2, fr[i]))
    done = rt.queues.drain_fused()
    jdone = jrt.queues.drain_fused()
    assert [r.frame_idx for r, _ in done] == [0, 2, 1]
    for (r, (b, s)), (jr, (jb, js)) in zip(done, jdone):
        assert r.frame_idx == jr.frame_idx
        np.testing.assert_allclose(s, np.asarray(js), **SCORES)
        np.testing.assert_allclose(b, np.asarray(jb), **BOXES)


def test_runtime_hold_skip_and_deferral_match_reference(weights, packets):
    """Chunk loss before a carry (frame skip, types 0), a hard loss with a
    carry (reuse hold), a forecast hold, and overload deferral with a deep
    overload (whole chunk on pipeline ③): types, results and every stat
    as the reference's; the accounting invariant holds."""
    sched = JF.FaultSchedule([
        JF.FaultEvent("chunk_loss", 0, 1, target=0, magnitude=1.0),
        JF.FaultEvent("chunk_loss", 2, 3, target=1, magnitude=1.0),
        JF.FaultEvent("chunk_corrupt", 1, 2, target=2, magnitude=0.7)],
        seed=5)
    rt, jrt = _runtimes(weights, faults=sched, gpu_capacity_fps=2.0)
    for t in range(3):
        for s in range(3):
            pk, jpk = port_packet(packets[s, t]), packets[s, t]
            if (s, t) == (2, 2):
                o, jo = rt.hold_chunk(s, t, pk), jrt.hold_chunk(s, t, jpk)
                _hold_poll(rt.poll(o), jrt.poll(jo))
                continue
            _hold_poll(rt.process_chunk(s, t, pk),
                       jrt.process_chunk(s, t, jpk), f"{s} {t}")
    acts = {a for st in rt.stats.values() for _, a, _ in st.events}
    assert {"frame_skip", "reuse_hold", "forecast_hold", "defer"} <= acts
    assert rt.deferred == jrt.deferred > 0
    np.testing.assert_array_equal(rt.demoted_frames, jrt.demoted_frames)
    np.testing.assert_array_equal(rt.reuse_fallback_chunks,
                                  jrt.reuse_fallback_chunks)
    _hold_stats(rt, jrt)


def test_runtime_evict_and_recover_match_reference(weights, packets):
    """Two logical shards, shard 1 eight times slower over chunks 1-5:
    the straggler detector evicts it and the runtime re-admits it; the
    fault logs, hedges and active shards equal the reference's.  Then a
    manual eviction re-homes queued requests, and the last shard stays."""
    sched = JF.FaultSchedule([JF.FaultEvent("shard_slow", 1, 6, target=1,
                                            magnitude=8.0)], seed=0)
    rt, jrt = _runtimes(weights, faults=sched, n_shards=2)
    for r in (rt, jrt):
        r.straggler.cfg.patience, r.straggler.cfg.window = 2, 4
    for t in range(9):
        for s in range(3):
            pk = packets[s, t % 3]
            _hold_poll(rt.process_chunk(s, t, port_packet(pk)),
                       jrt.process_chunk(s, t, pk), f"{s} {t}")
        rt.poll_faults(t)
        jrt.poll_faults(t)
        assert rt.active_shards == jrt.active_shards
    assert rt.fault_log == jrt.fault_log
    assert [a for _, a, _ in rt.fault_log] == ["evict", "recover"]
    assert rt.hedged_dispatches == jrt.hedged_dispatches
    assert rt.pool.healthy.tolist() == [True, True]
    _hold_stats(rt, jrt)
    tk = rt.submit_chunk(1, 9, port_packet(packets[1, 0]))
    assert tk.shard == 1 and rt.evict_shard(1, 9, reason="manual")
    assert tk.shard == 0 and all(r.shard == 0 for r in rt.queues.q1)
    assert not rt.evict_shard(0, 9)
    rt.poll(tk)
    rt.close()


def test_runtime_rejects_mesh_mode(weights):
    # mesh mode is ported (tests/test_torch_sharding.py); what the runtime
    # rejects is half of it: a mesh without rules, or rules without a mesh
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.distributed.sharding import SINGLE_POD_RULES
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    for kw in (dict(mesh=mesh), dict(rules=SINGLE_POD_RULES)):
        with pytest.raises(ValueError, match="BOTH mesh= and rules="):
            R.EdgeRuntime(SCH.ServingConfig(n_streams=2), weights[1], DET,
                          device="cpu", **kw)
    rt = R.EdgeRuntime(SCH.ServingConfig(n_streams=2), weights[1], DET,
                       mesh=mesh, rules=SINGLE_POD_RULES)
    assert rt.n_shards == 2 and rt.device == torch.device("cpu")


# -------------------------------------------------------------- serve
def _reference_frames(cfg, t0, n, *, device=None):
    """The port's ``generate_chunk`` replaced by the reference's frames of
    the same stream."""
    jcfg = JV.StreamConfig(**dataclasses.asdict(cfg))
    return tuple(torch.from_numpy(np.array(a)).to(device)
                 for a in JV.generate_chunk(None, jcfg, t0, n))


class _ReferenceFramesEnv(Env.MultiStreamEnv):
    """The port's env rendering the reference's frames."""

    def render(self, t0):
        T_ = self.cfg.chunk_frames
        out = []
        for ids in self.shape_groups.values():
            data = [_reference_frames(self.cfg.streams[c], t0, T_)
                    for c in ids]
            n = max(b.shape[1] for _, b, _ in data)
            boxes = torch.zeros((len(ids), T_, n, 4))
            valid = torch.zeros((len(ids), T_, n), dtype=torch.bool)
            for i, (_, b, v) in enumerate(data):
                boxes[i, :, :b.shape[1]], valid[i, :, :v.shape[1]] = b, v
            out.append((ids, torch.stack([f for f, _, _ in data]), boxes,
                        valid))
        return out


_LINE = re.compile(r"chunk (\d+) stream (\d+): bw=\s*([\d.]+)kbps "
                   r"types=(\[[\d, ]*\]) f1=([\d.]+) lat=\s*([\d.]+)ms")


def _chunk_lines(text):
    return [m.groups() for m in map(_LINE.match, text.splitlines()) if m]


@pytest.mark.parametrize("controller", ["even", "sac"])
def test_serve_main_matches_reference(weights, monkeypatch, capsys,
                                      controller):
    """``serve.main`` with ``--quick-train 0``, 3 streams x 2 chunks, the
    reference's frames and detector (and SAC agent) swapped in: each
    printed chunk line as the reference's (bandwidth to its printed kbps,
    types exactly, F1 and latency to their printed digits)."""
    jparams, params = weights
    argv = ["--streams", "3", "--chunks", "2", "--quick-train", "0",
            "--controller", controller]
    JLS.main(argv)
    ref = _chunk_lines(capsys.readouterr().out)

    jagent = JBC.create(jax.random.PRNGKey(2), JEnv.high_state_dim(
        JEnv.EnvConfig(streams=tuple(JV.paper_stream_mix(3, HH, WW)),
                       chunk_frames=T)), 3).agent
    create = LS.BandwidthController.create

    def carried(*a, **k):
        ctl = create(*a, **k)
        ctl.agent = sac_agent_from_jax(jax.tree.map(np.asarray, jagent),
                                       "cpu")
        return ctl

    monkeypatch.setattr(LS, "generate_chunk", _reference_frames)
    monkeypatch.setattr(LS.D, "init", lambda *a, **k: dict(params))
    monkeypatch.setattr(LS, "MultiStreamEnv", _ReferenceFramesEnv)
    monkeypatch.setattr(LS.BandwidthController, "create", carried)
    out = LS.main(argv, device="cpu")
    ours = _chunk_lines(capsys.readouterr().out)
    assert len(ours) == len(ref) == 6
    for o, r, f1, lat in zip(ours, ref, out["f1"], out["latency"]):
        assert o[:2] == r[:2] and o[3] == r[3], (o, r)
        assert abs(float(o[2]) - float(r[2])) <= 1.0, (o, r)
        assert abs(f1 - float(r[4])) <= 5e-4 + 1e-6, (o, r)
        assert abs(lat * 1e3 - float(r[5])) <= 0.05 + 1e-5 * lat * 1e3


def test_serve_detector_ckpt_is_not_ported(tmp_path):
    """The name is from when ``--detector-ckpt`` raised NotImplementedError.
    The flag is ported now (``tests/test_torch_train.py`` serves a
    reference checkpoint through it); this checks that a directory without
    a checkpoint raises FileNotFoundError, as the reference's restore of
    ``step_None`` does."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        LS.main(["--detector-ckpt", str(tmp_path / "x"), "--quick-train",
                 "0"], device="cpu")


# ---------------------------------------------- CUDA default, isolation
def test_serving_entry_points_default_to_cuda(weights, packets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    fr, gtb, gtv = _frames()
    pk = port_packet(packets[0, 0])
    calls = [
        lambda: E.encode_hybrid(fr, 6000.0, 0.05, 0.1),
        lambda: H.decode_and_execute(pk, weights[1], DET, gtb, gtv,
                                     bw_kbps=6000.0),
        lambda: H.decode_and_execute_fused(pk, weights[1], DET, gtb, gtv,
                                           bw_kbps=6000.0),
        lambda: R.EdgeRuntime(SCH.ServingConfig(n_streams=1), weights[1],
                              DET),
        lambda: F.run_soak(F.SoakConfig(n_chunks=12), F.preset_schedule(
            "loss-burst", n_chunks=12)),
        lambda: LS.main(["--quick-train", "0"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_serving_modules_import_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.core.hybrid_encoder, "
            "repro_torch.serving.runtime, repro_torch.serving.faults, "
            "repro_torch.serving.straggler, repro_torch.serving.elastic, "
            "repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert res.returncode == 0, res.stderr
