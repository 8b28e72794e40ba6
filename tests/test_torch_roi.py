"""The port's ROI gate (``repro_torch.core.roi``) and its ``roi_gather``
kernel module on the CPU, against ``repro.core.roi`` and
``repro.kernels.roi_gather`` on the same numpy inputs at 64x96, and the
ROI-gated round trip with the diamond bf16 search against the JAX
``roundtrip_chunk``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec.video_codec import VideoCodecConfig as JVideoCodecConfig
from repro.codec.video_codec import encode_chunk as j_encode_chunk
from repro.core import roi as JR
from repro.core import roundtrip as JRT
from repro.kernels.roi_gather.ops import roi_gather_ref
from repro.models import detection as JD
from repro.sim.video_source import StreamConfig as JStreamConfig
from repro.sim.video_source import generate_chunk as j_generate_chunk
from repro_torch.codec.video_codec import VideoCodecConfig
from repro_torch.core import roi as R
from repro_torch.core.roundtrip import (RoundtripConfig, roundtrip_chunk,
                                        roundtrip_oracle)
from repro_torch.kernels.roi_gather.ops import roi_gather, roi_gather_plain
from repro_torch.models import detection as D
from repro_torch.models.weights import detector_params_from_jax

HH, WW, T = 64, 96, 4
DET = D.TinyDetectorConfig()
JDET = JD.TinyDetectorConfig()


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


@pytest.fixture(scope="module")
def jparams():
    params = JD.init(jax.random.PRNGKey(1), JDET)
    # nonzero biases, so that the boundary masking is exercised
    rng = np.random.default_rng(7)
    return {k: (np.asarray(v) + (rng.normal(0, 0.1, v.shape) if v.ndim == 1
                                 else 0)).astype(np.float32)
            for k, v in params.items()}


@pytest.fixture(scope="module")
def params(jparams):
    return detector_params_from_jax(jparams, "cpu")


def _frames(seed=2, n=3):
    return np.random.default_rng(seed).uniform(0, 255, (n, HH, WW)) \
        .astype(np.float32)


# ----------------------------------------------------- config, validation
def test_roi_config_mirrors_the_reference():
    ours = {f.name: f.default for f in dataclasses.fields(R.RoiConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JR.RoiConfig)}
    assert ref.pop("use_kernel") is False
    assert ours == ref
    assert R.required_halo(DET) == JR.required_halo(JDET) == 7
    for stride in (2, 4):
        cfg = D.TinyDetectorConfig(stride=stride)
        assert R.required_halo(cfg) == JR.required_halo(
            JD.TinyDetectorConfig(stride=stride))
    assert R.region_grid((HH, WW), R.RoiConfig()) == (2, 3)


@pytest.mark.parametrize("roi,hd_hw", [
    (R.RoiConfig(region_px=24), (64, 96)),          # 24 does not divide 64
    (R.RoiConfig(region_px=32), (64, 100)),         # W not divisible
    (R.RoiConfig(halo=0), (64, 96)),                # halo < rf (7)
    (R.RoiConfig(halo=12), (64, 96)),               # halo % stride != 0
    (R.RoiConfig(capacity=0), (64, 96)),            # capacity < 1
    (R.RoiConfig(), (720, 1280)),                   # 32 does not divide 720
])
def test_validate_roi_rejects_bad_bindings(roi, hd_hw):
    with pytest.raises(ValueError):
        R.validate_roi(roi, DET, hd_hw)
    with pytest.raises(ValueError):
        JR.validate_roi(JR.RoiConfig(**dataclasses.asdict(roi)), JDET, hd_hw)


def test_validate_roi_accepts_the_card_binding():
    R.validate_roi(R.RoiConfig(), DET, (64, 96))
    R.validate_roi(R.RoiConfig(region_px=80, halo=8, capacity=36), DET,
                   (720, 1280))
    assert R.region_grid((720, 1280), R.RoiConfig(region_px=80)) == (9, 16)


# ------------------------------------------------------------- roi_gather
@pytest.mark.parametrize("T_,K,region_px,halo,lo,hi", [
    (2, 3, 32, 8, 0, 0), (1, 6, 32, 8, 0, 0), (3, 2, 16, 8, 0, 0),
    (2, 5, 16, 8, -2, 3)])        # out-of-range starts, as dynamic_slice
def test_roi_gather_plain_matches_ref(T_, K, region_px, halo, lo, hi):
    """An exact gather: equal to ``roi_gather_ref``, out-of-range region
    indices included.  (The reference's Pallas kernel does not run in
    interpret mode on this JAX: ``pl.load`` is gone.)"""
    nry, nrx = HH // region_px, WW // region_px
    rng = np.random.default_rng(K)
    planes = rng.uniform(0, 1, (T_, HH + 2 * halo, WW + 2 * halo)) \
        .astype(np.float32)
    ry = rng.integers(lo, nry + hi, (T_, K)).astype(np.int32)
    rx = rng.integers(lo, nrx + hi, (T_, K)).astype(np.int32)
    ours = roi_gather_plain(_t(planes), _t(ry), _t(rx), region_px=region_px,
                            halo=halo).numpy()
    ref = np.asarray(roi_gather_ref(jnp.asarray(planes), jnp.asarray(ry),
                                    jnp.asarray(rx), region_px=region_px,
                                    halo=halo))
    np.testing.assert_array_equal(ours, ref)


def test_roi_gather_wrapper_routes_cpu_and_checks():
    planes = torch.rand(2, 80, 112)
    ry = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    rx = torch.tensor([[2, 0], [1, 1]], dtype=torch.int32)
    out = roi_gather(planes, ry, rx, region_px=32, halo=8)
    assert out.shape == (2, 2, 48, 48)
    assert torch.equal(out, roi_gather_plain(planes, ry, rx, region_px=32,
                                             halo=8))
    assert torch.equal(out[1, 0], planes[1, 32:80, 32:80])
    with pytest.raises(ValueError):
        roi_gather(planes, ry[:, :1], rx, region_px=32, halo=8)
    with pytest.raises(ValueError):
        roi_gather(planes, ry, rx, region_px=128, halo=8)
    with pytest.raises(ValueError):
        roi_gather(planes.to("meta"), ry.to("meta"), rx.to("meta"),
                   region_px=32, halo=8)


# -------------------------------------------------------------- roi_select
@pytest.mark.parametrize("scores,capacity,threshold", [
    ([[5.0, 1.0, 5.0, 0.0, 5.0, 5.0]], 3, 2.0),        # ties + threshold
    ([[0.3, 0.1, 0.2, 0.0]], 2, 10.0),                  # none admitted
    ([[2.0, 3.0, 1.0]], 5, -1.0),                       # K > R
    ([[0.0] * 6, [1.0, 0.0, 1.0, 0.0, 1.0, 0.0]], 4, 0.0),  # static scene
])
def test_roi_select_matches_top_k(scores, capacity, threshold):
    idx, valid = R.roi_select(torch.tensor(scores), capacity, threshold)
    jidx, jvalid = JR.roi_select(jnp.asarray(scores, jnp.float32), capacity,
                                 threshold)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_roi_select_ties_everywhere_match_top_k():
    """Small integer scores: most regions tie, the common case on static
    background; the stable sort must keep lax.top_k's lower-index order."""
    scores = np.random.default_rng(3).integers(0, 3, (5, 3, 24)) \
        .astype(np.float32)
    for capacity, threshold in ((6, 0.0), (24, 1.0), (30, -1.0)):
        idx, valid = R.roi_select(torch.from_numpy(scores), capacity,
                                  threshold)
        jidx, jvalid = JR.roi_select(jnp.asarray(scores), capacity,
                                     threshold)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


# ---------------------------------------------------------- region_scores
@pytest.fixture(scope="module")
def encoded():
    raw, _, _ = j_generate_chunk(None, JStreamConfig(height=HH, width=WW,
                                                     n_objects=3, seed=0),
                                 0, T)
    lr = jnp.asarray(np.asarray(raw, np.float32)[:, :48, :64])
    enc = j_encode_chunk(lr, JVideoCodecConfig())
    return np.asarray(enc.mv), np.asarray(enc.residual_q)


@pytest.mark.parametrize("roi", [
    R.RoiConfig(), R.RoiConfig(region_px=16),
    R.RoiConfig(w_motion=0.5, w_resid=2.0)])
def test_region_scores_match(encoded, roi):
    mv, rq = encoded
    ours = R.region_scores(_t(mv), _t(rq), (48, 64), (HH, WW), roi)
    ref = JR.region_scores(jnp.asarray(mv), jnp.asarray(rq), (48, 64),
                           (HH, WW), JR.RoiConfig(**dataclasses.asdict(roi)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # the mixed-ladder extent is ported: the full extent is the identity,
    # and a smaller one matches the reference's
    full = R.region_scores(_t(mv), _t(rq), (48, 64), (HH, WW), roi,
                           lr_extent=(48, 64))
    assert torch.equal(full, ours)
    part = R.region_scores(_t(mv), _t(rq), (48, 64), (HH, WW), roi,
                           lr_extent=(32, 48))
    np.testing.assert_array_equal(part.numpy(), np.asarray(JR.region_scores(
        jnp.asarray(mv), jnp.asarray(rq), (48, 64), (HH, WW),
        JR.RoiConfig(**dataclasses.asdict(roi)), lr_extent=(32, 48))))


@pytest.mark.parametrize("roi", [
    R.RoiConfig(region_px=80, halo=8, capacity=36),
    R.RoiConfig(region_px=40, w_motion=0.5, w_resid=2.0)])
@pytest.mark.parametrize("lr_hw", [(352, 640), (480, 848)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_region_scores_match_at_the_ladder_shapes(lr_hw, roi):
    """720p sources at ladder rungs 2 (352x640) and 1 (480x848): MVs up to
    the search radius, sparse integer coefficients."""
    h, w = lr_hw
    rng = np.random.default_rng([h, w])
    mv = rng.integers(-8, 9, (3, h // 16, w // 16, 2)).astype(np.int32)
    rq = (np.round(rng.normal(0, 3, (3, (h // 8) * (w // 8), 8, 8)))
          * (rng.uniform(size=(3, (h // 8) * (w // 8), 8, 8)) < 0.2)) \
        .astype(np.float32)
    ours = R.region_scores(_t(mv), _t(rq), lr_hw, (720, 1280), roi)
    ref = JR.region_scores(jnp.asarray(mv), jnp.asarray(rq), lr_hw,
                           (720, 1280),
                           JR.RoiConfig(**dataclasses.asdict(roi)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---------------------------------------- patch forward, scatter, carry
def _selection(seed, n, R_, K):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(R_)[:K] for _ in range(n)]) \
        .astype(np.int32)
    valid = rng.uniform(size=(n, K)) < 0.7
    return idx, valid


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("region_px,K", [(32, 3), (16, 7)])
def test_forward_patches_and_raw_maps_match(jparams, params, carry,
                                            region_px, K):
    """Patch forward and the assembled maps against the reference, some
    lanes invalid, atol 1e-5 (convolutions sum in another order)."""
    roi = R.RoiConfig(region_px=region_px, capacity=K)
    jroi = JR.RoiConfig(region_px=region_px, capacity=K)
    frames = _frames(n=4)
    nrx = WW // region_px
    idx, valid = _selection(region_px, 4, (HH // region_px) * nrx, K)
    ry, rx = idx // nrx, idx % nrx
    patches = R.extract_patches(_t(frames), _t(ry), _t(rx), roi)
    jpatches = JR.extract_patches(jnp.asarray(frames), jnp.asarray(ry),
                                  jnp.asarray(rx), jroi)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jpatches))
    raws = R.forward_patches(params, DET, patches, _t(ry), _t(rx),
                             (HH, WW), roi)
    jraws = JR.forward_patches(jparams, JDET, jpatches, jnp.asarray(ry),
                               jnp.asarray(rx), (HH, WW), jroi)
    np.testing.assert_allclose(raws.numpy(), np.asarray(jraws), atol=1e-5)
    maps = R.roi_raw_maps(params, DET, roi, _t(frames), _t(idx), _t(valid),
                          carry=carry)
    jmaps = JR.roi_raw_maps(jparams, JDET, jroi, jnp.asarray(frames),
                            jnp.asarray(idx), jnp.asarray(valid),
                            carry=carry)
    assert maps.shape == (4, HH // 8, WW // 8, 5)
    np.testing.assert_allclose(maps.numpy(), np.asarray(jmaps), atol=1e-5)


def test_carry_keeps_last_output_and_never_selected_stays_zero(params):
    """Region 0 computed at frame 0 only: frames 1-2 carry its frame-0
    output; region 5 never selected: 0 everywhere; carry=False clears."""
    roi = R.RoiConfig(capacity=2)
    frames = _t(_frames(n=3))
    idx = torch.tensor([[0, 1], [1, 2], [2, 5]], dtype=torch.int32)
    valid = torch.tensor([[True, True], [True, True], [True, False]])
    maps = R.roi_raw_maps(params, DET, roi, frames, idx, valid)
    fresh = R.roi_raw_maps(params, DET, roi, frames, idx, valid,
                           carry=False)

    def region(m, t, r):                       # 2x3 regions of 4x4 cells
        return m[t, (r // 3) * 4:(r // 3) * 4 + 4, (r % 3) * 4:(r % 3) * 4 + 4]

    for t in (1, 2):
        assert torch.equal(region(maps, t, 0), region(maps, 0, 0))
        assert not bool(region(fresh, t, 0).any())
    assert bool(region(maps, 0, 0).any())
    for t in range(3):
        assert not bool(region(maps, t, 5).any())
        assert not bool(region(maps, t, 4).any())
    assert torch.equal(region(maps, 2, 1), region(maps, 1, 1))


@pytest.mark.parametrize("region_px", [32, 16])
def test_admit_all_equals_full_frame_forward(params, region_px):
    """Every region admitted: the assembled maps equal the port's own
    full-frame forward (atol 1e-5: the patch convolutions may sum in
    another order than the frame's)."""
    n_regions = (HH // region_px) * (WW // region_px)
    roi = R.RoiConfig(region_px=region_px, capacity=n_regions,
                      threshold=-1.0)
    frames = _t(_frames(n=3))
    idx = torch.arange(n_regions, dtype=torch.int32).expand(3, n_regions)
    maps = R.roi_raw_maps(params, DET, roi, frames, idx,
                          torch.ones(3, n_regions, dtype=torch.bool))
    full = D.forward(params, DET, frames)
    torch.testing.assert_close(maps, full, rtol=0, atol=1e-5)
    boxes, scores = R.roi_infer(params, DET, roi, frames,
                                torch.zeros(3, n_regions))
    fb, fs = D.decode_boxes(full, DET)
    torch.testing.assert_close(scores, fs, rtol=0, atol=1e-5)
    torch.testing.assert_close(boxes, fb, rtol=0, atol=1e-4)


def test_roi_detect_and_infer_match(jparams, params, encoded):
    mv, rq = encoded
    frames = _frames(n=T)
    roi = R.RoiConfig(capacity=3)
    jroi = JR.RoiConfig(capacity=3)
    boxes, scores = R.roi_detect(params, DET, roi, _t(frames), _t(mv),
                                 _t(rq), (48, 64))
    jb, js = JR.roi_detect(jparams, JDET, jroi, jnp.asarray(frames),
                           jnp.asarray(mv), jnp.asarray(rq), (48, 64))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), atol=1e-3)
    rs = np.random.default_rng(4).integers(0, 3, (T, 6)).astype(np.float32)
    boxes, scores = R.roi_infer(params, DET, roi, _t(frames), _t(rs))
    jb, js = JR.roi_infer(jparams, JDET, jroi, jnp.asarray(frames),
                          jnp.asarray(rs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), atol=1e-3)


# ------------------------------------------------------- the round trip
@pytest.fixture(scope="module")
def stream():
    raw, gtb, gtv = j_generate_chunk(None, JStreamConfig(
        height=HH, width=WW, n_objects=3, seed=0), 0, T)
    return np.array(raw), np.array(gtb), np.array(gtv)


CODEC = dict(search="diamond", dtype="bfloat16")


@pytest.mark.parametrize("tr1,tr2", [(0.05, 0.1), (0.5, 0.02)])
@pytest.mark.parametrize("level", [2, 3])
def test_roundtrip_chunk_roi_diamond_bf16_matches_jax(stream, jparams,
                                                      level, tr1, tr2):
    """The contract of test_roundtrip_chunk_matches_jax: types and
    anchor_q exact, bits rtol 1e-4, scores atol 1e-4, boxes atol 1e-2."""
    raw, gtb, gtv = stream
    jcfg = JRT.RoundtripConfig(level=level, codec=JVideoCodecConfig(**CODEC),
                               roi=JR.RoiConfig(capacity=3))
    ref = {k: np.asarray(v) for k, v in JRT.roundtrip_chunk(
        raw, gtb, gtv, jparams, tr1=tr1, tr2=tr2, bw_kbps=6000.0,
        cfg=jcfg).items()}
    cfg = RoundtripConfig(level=level, codec=VideoCodecConfig(**CODEC),
                          roi=R.RoiConfig(capacity=3))
    ours = {k: v.numpy() for k, v in roundtrip_chunk(
        raw, gtb, gtv, detector_params_from_jax(jparams, "cpu"), tr1=tr1,
        tr2=tr2, bw_kbps=6000.0, cfg=cfg, device="cpu").items()}
    assert set(ours) == set(ref)
    np.testing.assert_array_equal(ours["types"], ref["types"])
    np.testing.assert_array_equal(ours["anchor_q"], ref["anchor_q"])
    for k in ("video_bits", "anchor_bits", "total_bits"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(ours["scores"], ref["scores"], atol=1e-4)
    np.testing.assert_allclose(ours["boxes"], ref["boxes"], atol=1e-2)
    for k in ("latency", "t_trans", "t_comp", "t_queue"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, err_msg=k)


def test_roundtrip_oracle_with_roi_equals_roundtrip_chunk(stream, params):
    raw, gtb, gtv = stream
    cfg = RoundtripConfig(level=3, codec=VideoCodecConfig(**CODEC),
                          roi=R.RoiConfig(capacity=3))
    kw = dict(tr1=0.5, tr2=0.02, bw_kbps=6000.0, cfg=cfg, device="cpu")
    fused = roundtrip_chunk(raw, gtb, gtv, params, **kw)
    oracle = roundtrip_oracle(raw, gtb, gtv, params, **kw)
    assert set(fused) == set(oracle)
    for k in fused:
        torch.testing.assert_close(fused[k], oracle[k], rtol=1e-6, atol=0,
                                   msg=k)
