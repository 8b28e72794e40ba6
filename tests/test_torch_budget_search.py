"""The port's anchor budget search on the CPU: ``jpeg_bits``,
``ladder_bits``, ``ladder_sweep``, ``budget_rung`` and
``quality_for_budget`` against the JAX package, and the fused search of
``roundtrip_chunk`` / ``roundtrip_batched`` and the oracle's per-anchor
probe against the reference's ``anchor_search=True`` round trips.

Contract: chosen rungs and ``anchor_q`` exact; bits within rtol 1e-5 of
the reference (the bit proxy's log2 and sums run in another library), as
``test_torch_codec.py`` holds them; the port's fused search and its
oracle agree bit for bit on every key."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import image_codec as JI
from repro.core import roundtrip as JRT
from repro.models import detection as JD
from repro.sim.video_source import StreamConfig, generate_chunk
from repro_torch.codec import image_codec as I
from repro_torch.core import roundtrip as RT
from repro_torch.models.weights import detector_params_from_jax
from test_torch_anchor_stage_card import masked_anchors, spread_bandwidths

H, W, T = 64, 96, 4
QS = np.asarray(I.ANCHOR_QUALITY_LADDER, np.float32)
BANDWIDTHS = (30.0, 60.0, 900.0, 8000.0, 50000.0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def imgs():
    frames, _, _ = generate_chunk(None, StreamConfig(height=H, width=W,
                                                     n_objects=3, seed=3),
                                  0, 3)
    return np.asarray(frames, np.float32)


@pytest.fixture(scope="module")
def jparams():
    params = JD.init(jax.random.PRNGKey(1), JD.TinyDetectorConfig())
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def params(jparams):
    return detector_params_from_jax(jparams, "cpu")


@pytest.fixture(scope="module")
def streams():
    data = [generate_chunk(None, StreamConfig(height=H, width=W, n_objects=3,
                                              seed=s), 0, T)
            for s in range(3)]
    return tuple(np.stack([np.asarray(d[i]) for d in data]) for i in range(3))


def test_ladder_matches_reference():
    assert I.ANCHOR_QUALITY_LADDER == JI.ANCHOR_QUALITY_LADDER


@pytest.mark.parametrize("quality", I.ANCHOR_QUALITY_LADDER)
def test_jpeg_bits_matches_reference(imgs, quality):
    ours = I.jpeg_bits(_t(imgs), quality)
    assert ours.shape == (3,)
    for t in range(3):
        np.testing.assert_allclose(float(ours[t]), float(
            JI.jpeg_bits(jnp.asarray(imgs[t]), quality)), rtol=1e-5)
        # the bits of jpeg_encode_decode, bit for bit
        assert torch.equal(ours[t], I.jpeg_encode_decode(_t(imgs[t]),
                                                         quality)[1])


def test_ladder_bits_matches_reference_and_per_rung_bits(imgs):
    ours = I.ladder_bits(_t(imgs))
    assert ours.shape == (3, len(QS))
    for t in range(3):
        np.testing.assert_allclose(ours[t].numpy(), np.asarray(
            JI.ladder_bits(jnp.asarray(imgs[t]))), rtol=1e-5)
        assert torch.equal(I.ladder_bits(_t(imgs[t])), ours[t])
        for r, q in enumerate(QS):
            assert torch.equal(ours[t, r], I.jpeg_bits(_t(imgs[t]), float(q)))


def test_ladder_sweep_matches_reference_and_per_rung_encodes(imgs):
    recs, bits = I.ladder_sweep(_t(imgs[0]))
    jrecs, jbits = JI.ladder_sweep(jnp.asarray(imgs[0]))
    assert recs.shape == (len(QS), H, W) and bits.shape == (len(QS),)
    np.testing.assert_allclose(bits.numpy(), np.asarray(jbits), rtol=1e-5)
    # a coefficient that rounds the other way at a .5 boundary moves its
    # block; none does on this frame
    np.testing.assert_allclose(recs.numpy(), np.asarray(jrecs), atol=1e-3)
    for r, q in enumerate(QS):
        rec, b = I.jpeg_encode_decode(_t(imgs[0]), float(q))
        assert torch.equal(recs[r], rec) and torch.equal(bits[r], b)
    batch_recs, batch_bits = I.ladder_sweep(_t(imgs))
    assert torch.equal(batch_recs[0], recs) and torch.equal(batch_bits[0],
                                                            bits)


def _budgets(bits):
    return ([0.0, float(bits.min()) - 1.0, float(bits.max()) + 1.0, 1e9]
            + [float(b) for b in bits]                 # exact boundaries
            + [float(b) - 0.5 for b in bits] + [float(b) + 0.5 for b in bits])


def test_budget_rung_golden_sweep_matches_reference(imgs):
    bits = I.ladder_bits(_t(imgs[0]))
    for budget in _budgets(bits.numpy()):
        ours = int(I.budget_rung(bits, budget))
        assert ours == int(JI.budget_rung(jnp.asarray(bits.numpy()),
                                          budget)), budget
        q, b = I.quality_for_budget(_t(imgs[0]), budget)
        assert float(q) == QS[ours] and torch.equal(b, bits[ours])


def test_budget_rung_below_cheapest_ships_rung_zero(imgs):
    bits = I.ladder_bits(_t(imgs[0]))
    assert int(I.budget_rung(bits, 0.0)) == 0
    q, b = I.quality_for_budget(_t(imgs[0]), 0.0)
    jq, jb = JI.quality_for_budget(jnp.asarray(imgs[0]), 0.0)
    assert float(q) == QS[0] == float(jq)
    assert torch.equal(b, bits[0])
    np.testing.assert_allclose(float(b), float(jb), rtol=1e-5)


def test_budget_rung_batched_rows_and_budgets(imgs):
    bits = I.ladder_bits(_t(imgs))                        # (3, Q)
    budgets = torch.tensor([0.0, float(bits[1, 2]), 1e9])
    rows = I.budget_rung(bits, budgets)
    for t in range(3):
        assert int(rows[t]) == int(I.budget_rung(bits[t], budgets[t]))
        assert int(rows[t]) == int(JI.budget_rung(
            jnp.asarray(bits[t].numpy()), float(budgets[t])))
    assert rows.tolist() == [0, 2, len(QS) - 1]
    q, b = I.quality_for_budget(_t(imgs), budgets)
    assert q.tolist() == QS[rows.numpy()].tolist()
    assert torch.equal(b, bits.gather(1, rows[:, None])[:, 0])


# ------------------------------------------------- the search in a round trip
def _cfg(level=3):
    return RT.RoundtripConfig(level=level, anchor_search=True)


def _hold_search(ours: dict, ref: dict, label: str):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(ours["types"].numpy(), ref["types"],
                                  err_msg=label)
    np.testing.assert_array_equal(ours["anchor_q"].numpy(), ref["anchor_q"],
                                  err_msg=label)
    for k in ("video_bits", "anchor_bits", "total_bits"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], rtol=1e-5,
                                   err_msg=f"{label}: {k}")
    np.testing.assert_allclose(ours["scores"].numpy(), ref["scores"],
                               atol=1e-4, err_msg=label)
    np.testing.assert_allclose(ours["latency"].numpy(), ref["latency"],
                               rtol=1e-5, err_msg=label)


@pytest.mark.parametrize("bw", BANDWIDTHS)
def test_roundtrip_chunk_search_matches_reference_and_oracle(
        streams, jparams, params, bw):
    raw, gtb, gtv = streams
    kw = dict(tr1=0.05, tr2=0.1, bw_kbps=bw)
    fused = RT.roundtrip_chunk(raw[0], gtb[0], gtv[0], params, cfg=_cfg(),
                               device="cpu", **kw)
    oracle = RT.roundtrip_oracle(raw[0], gtb[0], gtv[0], params, cfg=_cfg(),
                                 device="cpu", **kw)
    assert set(fused) == set(oracle)
    for k in oracle:
        assert torch.equal(fused[k], oracle[k]), f"bw={bw}: {k}"
    jcfg = JRT.RoundtripConfig(level=3, anchor_search=True)
    _hold_search(fused, JRT.roundtrip_chunk(raw[0], gtb[0], gtv[0], jparams,
                                            cfg=jcfg, **kw), f"bw={bw}")
    _hold_search(oracle, JRT.roundtrip_oracle(raw[0], gtb[0], gtv[0],
                                              jparams, cfg=jcfg, **kw),
                 f"oracle bw={bw}")


def test_search_responds_to_bandwidth_and_charges_chosen_bits(streams,
                                                              params):
    raw, gtb, gtv = streams
    kw = dict(tr1=0.05, tr2=0.1, cfg=_cfg(), device="cpu")
    lo = RT.roundtrip_chunk(raw[0], gtb[0], gtv[0], params, bw_kbps=30.0,
                            **kw)
    hi = RT.roundtrip_chunk(raw[0], gtb[0], gtv[0], params, bw_kbps=50000.0,
                            **kw)
    anchors = lo["types"] == 1
    assert bool(anchors.any())
    assert (lo["anchor_q"][anchors] == QS[0]).all()
    assert (hi["anchor_q"][anchors] == QS[-1]).all()
    bits = I.ladder_bits(torch.as_tensor(raw[0]))
    for out in (lo, hi):
        rungs = torch.as_tensor(np.searchsorted(QS, out["anchor_q"].numpy()))
        charged = torch.where(anchors, bits.gather(1, rungs[:, None])[:, 0],
                              0.0)
        assert torch.equal(out["anchor_bits"], RT.B.seq_sum(charged))


def test_roundtrip_batched_search_matches_reference_and_own_lanes(
        streams, jparams, params):
    raw, gtb, gtv = streams
    sc = dict(tr1=np.full(3, 0.05, np.float32),
              tr2=np.full(3, 0.1, np.float32),
              bw_kbps=np.array([900.0, 3000.0, 60.0], np.float32),
              queue_delay=np.zeros(3, np.float32))
    out = RT.roundtrip_batched(raw, gtb, gtv, params, cfg=_cfg(),
                               device="cpu", **sc)
    ref = JRT.roundtrip_batched(raw, gtb, gtv, jparams,
                                cfg=JRT.RoundtripConfig(level=3,
                                                        anchor_search=True),
                                **sc)
    for s in range(3):
        lane = {k: v[s] for k, v in out.items()}
        _hold_search(lane, {k: np.asarray(v)[s] for k, v in ref.items()},
                     f"lane {s}")
        oracle = RT.roundtrip_oracle(
            raw[s], gtb[s], gtv[s], params, tr1=0.05, tr2=0.1,
            bw_kbps=float(sc["bw_kbps"][s]), cfg=_cfg(), device="cpu")
        for k in oracle:
            assert torch.equal(lane[k], oracle[k]), f"lane {s}: {k}"


def test_ladder_batched_search_lanes_equal_single_stream(streams, params):
    raw, gtb, gtv = streams
    levels = (4, 2, 3)
    sc = dict(tr1=0.05, tr2=0.1, bw_kbps=np.array([900.0, 3000.0, 60.0]),
              queue_delay=0.0)
    out = RT.roundtrip_ladder_batched(raw, gtb, gtv, params, levels=levels,
                                      cfg=_cfg(), device="cpu", **sc)
    for s, level in enumerate(levels):
        one = RT.roundtrip_chunk(raw[s], gtb[s], gtv[s], params, tr1=0.05,
                                 tr2=0.1, bw_kbps=float(sc["bw_kbps"][s]),
                                 cfg=dataclasses.replace(_cfg(), level=level),
                                 device="cpu")
        for k in one:
            assert torch.equal(out[k][s], one[k]), f"lane {s}: {k}"


# ------------------------------------------------ the anchor stage's gather
# Eq. 3's types of three streams: one anchor a stream, mixed, every frame
TYPE_CASES = {
    "i_frame_only": [[1, 3, 3, 2], [1, 2, 3, 3], [1, 3, 2, 3]],
    "mixed": [[1, 3, 1, 2], [1, 1, 3, 1], [1, 2, 3, 3]],
    "every_frame": [[1] * T] * 3,
}


@pytest.mark.parametrize("search", [False, True], ids=["pinned", "search"])
@pytest.mark.parametrize("case", list(TYPE_CASES))
def test_anchor_stage_encodes_only_anchors_bit_for_bit(streams, case,
                                                       search):
    """``_anchors`` encodes Eq. 3's anchors alone and scatters them into
    zeros: bit for bit the masked every-frame form, the counter showing
    the frames given and encoded."""
    raw = torch.as_tensor(streams[0], dtype=torch.float32)
    types_host = np.asarray(TYPE_CASES[case], np.int32)
    types = torch.from_numpy(types_host)
    video_bits = torch.tensor([900.0, 2500.0, 400.0])
    cfg = RT.RoundtripConfig(anchor_search=search)
    bw = spread_bandwidths(raw, types_host, video_bits)
    want = masked_anchors(raw, types, video_bits, bw, cfg)
    RT.ANCHOR_FRAMES.clear()
    got = RT._anchors(raw, types_host, video_bits, bw, cfg)
    for name, a, b in zip(("anchor_hd", "anchor_bits", "anchor_q"), got,
                          want):
        assert torch.equal(a, b), name
    assert RT.ANCHOR_FRAMES == {"given": raw.shape[0] * T,
                                "encoded": int((types_host == 1).sum())}
    if search:
        assert len(torch.unique(got[2][types == 1])) > 1
