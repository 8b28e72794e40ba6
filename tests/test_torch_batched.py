"""The port's multi-stream forms on the CPU: ``seq_sum`` in the
reference's order, the masked rate model, the per-frame quantisation
tables, the batched and mixed-ladder encodes, the batched decode and the
batched / mixed-ladder / padded round trips, held against the JAX
package on the same numpy inputs; each lane of the port's batched forms
held bit for bit against the port's own single-stream path; and the
stream sets and the batched renderer of ``sim.video_source``.

Tolerances against the reference are those of ``test_torch_codec.py`` and
``test_torch_roundtrip.py``: the port's f32 sums and transcendentals run
in other orders than XLA's.  The lanes of the port's batched forms against
its single-stream path share every operation, so they are held bit for
bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import blockdct as JB
from repro.codec import motion as JM
from repro.codec import rate_model as JR
from repro.codec import video_codec as JV
from repro.core import hybrid_decoder as JH
from repro.core import roi as JROI
from repro.core import roundtrip as JRT
from repro.models import detection as JD
from repro.sim import video_source as JS
from repro_torch.codec import blockdct as B
from repro_torch.codec import motion as M
from repro_torch.codec import video_codec as V
from repro_torch.codec.rate_model import (QUALITY_LADDER, downscale,
                                          ladder_lr_shape)
from repro_torch.core import hybrid_decoder as H
from repro_torch.core import roi as R
from repro_torch.core import roundtrip as RT
from repro_torch.kernels.blockdct import ops as dct_ops
from repro_torch.kernels.seq_sum.ops import seq_sum as seq_sum_kernel
from repro_torch.kernels.seq_sum.ops import seq_sum_plain
from repro_torch.models.weights import detector_params_from_jax
from repro_torch.sim import video_source as S

HH, WW, T = 64, 96, 4
LADDER_SHAPES = ((32, 48), (48, 64), (64, 96))    # three streams' LR shapes
LADDER_QUALITIES = (30.0, 50.0, 80.0)
MIXED_LEVELS = (4, 3, 2)
ENC_FIELDS = ("recon", "mv", "residual_q", "qtab", "bits", "residual_mag",
              "frame_diff")


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


def _frames(h, w, seed, n=T):
    raw, _, _ = JS.generate_chunk(None, JS.StreamConfig(
        height=h, width=w, n_objects=3, seed=seed), 0, n)
    return np.array(raw, np.float32)        # writable, as torch asks


@pytest.fixture(scope="module")
def streams():
    data = [JS.generate_chunk(None, JS.StreamConfig(
        height=HH, width=WW, n_objects=3, seed=s), 0, T) for s in range(3)]
    return tuple(np.stack([np.asarray(d[i]) for d in data]) for i in range(3))


@pytest.fixture(scope="module")
def jparams():
    params = JD.init(jax.random.PRNGKey(1), JD.TinyDetectorConfig())
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def params(jparams):
    return detector_params_from_jax(jparams, "cpu")


def _scalars(n=3):
    return dict(tr1=np.full(n, 0.5, np.float32),
                tr2=np.full(n, 0.02, np.float32),
                bw_kbps=np.array([6000.0, 3000.0, 1500.0][:n], np.float32),
                queue_delay=np.array([0.0, 0.01, 0.02][:n], np.float32))


# ------------------------------------------------------------------ seq_sum
@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33, 64, 129, 200])
def test_seq_sum_vector_bit_exact_and_zero_suffix_invariant(n):
    rng = np.random.default_rng(n)
    v = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 4, n)) \
        .astype(np.float32)
    ours = B.seq_sum(_t(v))
    assert ours.shape == () and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(JB.seq_sum(jnp.asarray(v))))
    padded = np.concatenate([v, np.zeros(7, np.float32)])
    assert torch.equal(B.seq_sum(_t(padded)), ours)


@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 200), (200, 1), (3, 5),
                                       (7, 13), (10, 20), (14, 14)])
def test_seq_sum_grid_bit_exact_and_zero_padding_invariant(rows, cols):
    rng = np.random.default_rng([rows, cols])
    g = (rng.standard_normal((rows, cols))
         * 10.0 ** rng.uniform(-3, 4, (rows, cols))).astype(np.float32)
    ours = B.seq_sum(_t(g))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(JB.seq_sum(jnp.asarray(g))))
    # a column suffix within each row and a suffix of all-zero rows
    padded = np.pad(g, ((0, 3), (0, 5)))
    assert torch.equal(B.seq_sum(_t(padded)), ours)
    # leading axes are independent lanes
    lanes = np.stack([g, 2 * g, np.zeros_like(g)])
    both = B.seq_sum(_t(lanes)[None], 2)
    assert both.shape == (1, 3)
    assert torch.equal(both[0, 0], ours)
    np.testing.assert_array_equal(both[0, 1].numpy(), np.asarray(
        JB.seq_sum(jnp.asarray(2 * g))))


def test_seq_sum_differs_from_a_plain_sum_where_the_order_matters():
    # the order is what the tests above hold: a torch.sum of rows then
    # columns gives another value on this grid
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((44, 80))
         * 10.0 ** rng.uniform(-3, 4, (44, 80))).astype(np.float32)
    ref = np.asarray(JB.seq_sum(jnp.asarray(g)))
    assert float(_t(g).sum(-1).sum(-1)) != float(ref)
    np.testing.assert_array_equal(B.seq_sum(_t(g)).numpy(), ref)


def test_seq_sum_wrapper_routes_cpu_to_plain_and_checks():
    x = torch.randn(4, 3, 5)
    assert torch.equal(seq_sum_kernel(x), seq_sum_plain(x))
    for bad in (torch.zeros(3, 5), torch.zeros(0, 3, 5)):
        with pytest.raises(ValueError, match="x must be"):
            seq_sum_kernel(bad)
    with pytest.raises(TypeError):
        seq_sum_kernel(x.double())
    with pytest.raises(ValueError, match="cpu or cuda"):
        seq_sum_kernel(x.to("meta"))


# ------------------------------------------------------- masked rate model
def _masks(Hp, Wp, h, w):
    ours = V._extent_masks(Hp, Wp, torch.tensor([[h, w]]))
    ref = JV._extent_masks(Hp, Wp, jnp.int32(h), jnp.int32(w))
    return ours, ref


@pytest.mark.parametrize("h,w", [(64, 96), (48, 64), (32, 48), (16, 16)])
def test_masked_entropy_bits_matches_reference(h, w):
    Hp, Wp = 64, 96
    q = np.round(np.random.default_rng(h * w).normal(0, 3, (96, 8, 8))) \
        .astype(np.float32)
    ours_m, ref_m = _masks(Hp, Wp, h, w)
    ours = B.entropy_bits(_t(q), ours_m["bm8"][0], ours_m["n8"][0],
                          grid=(Hp // 8, Wp // 8))
    ref = JB.entropy_bits(jnp.asarray(q), ref_m["bm8"], ref_m["n8"],
                          grid=(Hp // 8, Wp // 8))
    # log2 of another library: rtol 1e-5, as test_torch_codec.py holds
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    # zeroed padding charges nothing: the unpadded frame's bits, exactly
    grid = q.reshape(Hp // 8, Wp // 8, 8, 8)[:h // 8, :w // 8]
    unpadded = B.entropy_bits(_t(grid.reshape(-1, 8, 8)),
                              grid=(h // 8, w // 8))
    assert torch.equal(ours, unpadded)


@pytest.mark.parametrize("h,w", [(64, 96), (48, 64), (32, 48)])
def test_masked_mean_abs_matches_reference(h, w):
    rng = np.random.default_rng(h + w)
    x = rng.normal(0, 20, (64, 96)).astype(np.float32)
    ours_m, ref_m = _masks(64, 96, h, w)
    ours = V._mean_abs(_t(x)[None], ours_m)[0]
    ref = JV._mean_abs(jnp.asarray(x), ref_m)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(V._mean_abs(_t(x)[None])[0]),
                               float(JV._mean_abs(jnp.asarray(x), None)),
                               rtol=1e-5)
    # the masked mean over the padded frame is the unpadded one, exactly
    assert torch.equal(ours, V._mean_abs(_t(x[:h, :w])[None])[0])


def test_extent_masks_and_edge_extend_match_reference():
    Hp, Wp, h, w = 64, 96, 32, 48
    ours, ref = _masks(Hp, Wp, h, w)
    for k in ("pix", "bm8", "mb"):
        np.testing.assert_array_equal(ours[k][0].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("n8", "nmb", "recip"):
        np.testing.assert_array_equal(ours[k][0].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    x = np.random.default_rng(5).uniform(0, 255, (2, Hp, Wp)) \
        .astype(np.float32)
    ext = V._edge_extend(_t(x)[None], ours)[0]
    for f in range(2):
        np.testing.assert_array_equal(ext[f].numpy(), np.asarray(
            JV._edge_extend(jnp.asarray(x[f]), h, w)))


# -------------------------------------------------- per-frame quant tables
@pytest.mark.parametrize("F,H,W", [(3, 8, 24), (5, 24, 40), (4, 64, 96)])
def test_blockdct_per_frame_tables_equal_per_frame_calls(F, H, W):
    rng = np.random.default_rng(F * H)
    frames = _t(rng.uniform(-128, 127, (F, H, W)).astype(np.float32))
    D = B.dct_matrix()
    tabs = B.quant_table([20.0, 50.0, 80.0, 92.0, 35.0][:F] + [65.0] * (F - 5)
                         if F > 5 else [20.0, 50.0, 80.0, 92.0, 35.0][:F])
    q, rec = dct_ops.forward_quant_raster(frames, D, tabs)
    inv = dct_ops.inverse_raster(q, D, tabs, H, W)
    for f in range(F):
        qf, recf = dct_ops.forward_quant_raster(frames[f:f + 1], D, tabs[f])
        assert torch.equal(q[f:f + 1], qf) and torch.equal(rec[f:f + 1],
                                                            recf)
        assert torch.equal(inv[f:f + 1], dct_ops.inverse_raster(
            qf, D, tabs[f], H, W))
    # one table repeated is the (8, 8) form, bit for bit
    same = tabs[:1].expand(F, 8, 8).contiguous()
    q1, r1 = dct_ops.forward_quant_raster(frames, D, same)
    q2, r2 = dct_ops.forward_quant_raster(frames, D, tabs[0])
    assert torch.equal(q1, q2) and torch.equal(r1, r2)
    # the codec entry broadcasts a table a stream over its frames
    qs, _ = B.dct_quantize_raster(frames.reshape(1, F, H, W), tabs[None])
    assert torch.equal(qs[0], q)


def test_blockdct_table_shapes_checked():
    D = B.dct_matrix()
    frames = torch.zeros((3, 16, 24))
    for bad in (B.quant_table([50.0, 70.0]), torch.zeros(3, 8, 4)):
        with pytest.raises(ValueError, match="dmat and qtab"):
            dct_ops.forward_quant_raster(frames, D, bad)
        with pytest.raises(ValueError, match="dmat and qtab"):
            dct_ops.inverse_raster(torch.zeros(3, 6, 8, 8), D, bad, 16, 24)


def test_quant_tables_for_many_qualities_match_reference():
    qs = [1.0, 20.0, 35.0, 50.0, 65.0, 80.0, 92.0, 120.0]
    tabs = B.quant_table(qs)
    for i, q in enumerate(qs):
        np.testing.assert_array_equal(tabs[i].numpy(),
                                      np.asarray(JB.quant_table(q)))


# ------------------------------------------------------------- motion
@pytest.mark.parametrize("shape", [(5, 2, 3, 2), (2, 4, 3, 4, 2)])
def test_accumulate_mv_matches_reference(shape):
    mvs = np.random.default_rng(len(shape)).integers(-8, 9, shape) \
        .astype(np.int32)
    ours = M.accumulate_mv(_t(mvs))
    assert ours.dtype == torch.int32
    if len(shape) == 4:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(
            JM.accumulate_mv(jnp.asarray(mvs))))
    else:       # a leading stream axis: each stream's own running sum
        for s in range(shape[0]):
            np.testing.assert_array_equal(ours[s].numpy(), np.asarray(
                JM.accumulate_mv(jnp.asarray(mvs[s]))))


# ------------------------------------------------------------- the encodes
def _hold_encode(ours, ref, qtab_rtol=0.0):
    """The contract of test_torch_codec.py::test_encode_chunk_matches:
    MVs exact, coefficients within 1, recon within 1e-3 outside the blocks
    where a coefficient moved, bits and features rtol 1e-5; the tables
    exact unless ``qtab_rtol`` says otherwise."""
    np.testing.assert_array_equal(ours.mv.numpy(), np.asarray(ref.mv))
    dq = np.abs(ours.residual_q.numpy() - np.asarray(ref.residual_q))
    assert dq.max() <= 1.0
    flip = (dq > 0).any(axis=(-2, -1))
    Hc, Wc = ours.recon.shape[-2:]
    ok = ~B.unblockify(_t(np.broadcast_to(flip[..., None, None],
                                          (*flip.shape, 8, 8))),
                       Hc, Wc).numpy()
    np.testing.assert_allclose(ours.recon.numpy()[ok],
                               np.asarray(ref.recon)[ok], atol=1e-3)
    np.testing.assert_allclose(ours.qtab.numpy(), np.asarray(ref.qtab),
                               rtol=qtab_rtol, atol=0)
    for k in ("bits", "residual_mag", "frame_diff"):
        np.testing.assert_allclose(getattr(ours, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-5,
                                   err_msg=k)


def _hold_lane(lane, single, h, w):
    """Lane of a padded encode == the unpadded encode over (h, w), bit for
    bit; the padded MVs and coefficients zero, the recon margin the edge
    replication."""
    Hp, Wp = lane.recon.shape[-2:]
    assert torch.equal(lane.recon[:, :h, :w], single.recon)
    assert torch.equal(lane.mv[:, :h // 16, :w // 16], single.mv)
    bm = ((torch.arange(Hp // 8)[:, None] < h // 8)
          & (torch.arange(Wp // 8)[None, :] < w // 8)).reshape(-1)
    assert torch.equal(lane.residual_q[:, bm], single.residual_q)
    assert not lane.residual_q[:, ~bm].any()
    assert not lane.mv[:, h // 16:].any() and not lane.mv[:, :, w // 16:].any()
    assert torch.equal(lane.recon[:, h:],
                       lane.recon[:, h - 1:h].expand_as(lane.recon[:, h:]))
    for k in ("qtab", "bits", "residual_mag", "frame_diff"):
        assert torch.equal(getattr(lane, k), getattr(single, k)), k


@pytest.mark.parametrize("search", ["exhaustive", "diamond"])
def test_encode_chunk_batched_matches_reference_and_own_lanes(search):
    frames = np.stack([_frames(48, 64, s) for s in range(3)])
    cfg = V.VideoCodecConfig(search=search)
    ours = V.encode_chunk_batched(frames, cfg, device="cpu")
    ref = JV.encode_chunk_batched(jnp.asarray(frames),
                                  JV.VideoCodecConfig(search=search))
    assert ours.qtab.shape == (3, 8, 8)
    _hold_encode(ours, ref)
    for s in range(3):
        single = V.encode_chunk(frames[s], cfg, device="cpu")
        for k in ENC_FIELDS:
            assert torch.equal(getattr(ours.lane(s), k), getattr(single, k))


@pytest.fixture(scope="module")
def ladder_chunks():
    return [_frames(h, w, 10 + s) for s, (h, w) in enumerate(LADDER_SHAPES)]


def test_pad_ladder_batch_matches_reference(ladder_chunks):
    frames, extents = V.pad_ladder_batch(ladder_chunks, device="cpu")
    jf, je = JV.pad_ladder_batch([jnp.asarray(c) for c in ladder_chunks])
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(extents.numpy(), np.asarray(je))
    assert extents.dtype == torch.int32


@pytest.mark.parametrize("radius", [4, 8])
def test_encode_chunk_ladder_batched_matches_reference(ladder_chunks, radius):
    """Three streams at 32x48, 48x64 and 64x96 with mixed QPs in one padded
    encode, against the reference function's own output (its documented
    bit-exactness against the unpadded encode is red on this JAX)."""
    frames, extents = V.pad_ladder_batch(ladder_chunks, device="cpu")
    cfg = V.VideoCodecConfig(search_radius=radius)
    ours = V.encode_chunk_ladder_batched(frames, extents, LADDER_QUALITIES,
                                         cfg, device="cpu")
    jf, je = JV.pad_ladder_batch([jnp.asarray(c) for c in ladder_chunks])
    ref = JV.encode_chunk_ladder_batched(
        jf, je, jnp.asarray(LADDER_QUALITIES, jnp.float32),
        JV.VideoCodecConfig(search_radius=radius))
    # the reference builds a traced quality's table inside its jit, where
    # XLA rounds 5000/q/100 differently from its own static table (one ulp,
    # 1.2e-7 relative); the port's tables equal the static ones, which is
    # what its lanes need to equal encode_chunk
    _hold_encode(ours, ref, qtab_rtol=2.5e-7)
    for s, quality in enumerate(LADDER_QUALITIES):
        np.testing.assert_array_equal(ours.qtab[s].numpy(),
                                      np.asarray(JB.quant_table(quality)))


@pytest.mark.parametrize("search,dtype", [("exhaustive", "float32"),
                                          ("diamond", "bfloat16")])
def test_encode_ladder_lanes_equal_unpadded_encode(ladder_chunks, search,
                                                   dtype):
    """The port against itself: lane s of the padded encode equals the
    port's encode_chunk on stream s's unpadded frames, bit for bit, and
    garbage in the margin leaks into nothing."""
    frames, extents = V.pad_ladder_batch(ladder_chunks, device="cpu")
    cfg = V.VideoCodecConfig(search=search, dtype=dtype)
    enc = V.encode_chunk_ladder_batched(frames, extents, LADDER_QUALITIES,
                                        cfg, device="cpu")
    for s, chunk in enumerate(ladder_chunks):
        single = V.encode_chunk(chunk, dataclasses.replace(
            cfg, quality=LADDER_QUALITIES[s]), device="cpu")
        _hold_lane(enc.lane(s), single, *chunk.shape[1:])
    poisoned = frames.clone()
    poisoned[0, :, 32:] = 255.0
    poisoned[1, :, :, 64:] = 77.0
    again = V.encode_chunk_ladder_batched(poisoned, extents,
                                          LADDER_QUALITIES, cfg, device="cpu")
    for k in ENC_FIELDS:
        assert torch.equal(getattr(again, k), getattr(enc, k)), k


def test_full_extent_ladder_encode_equals_batched():
    frames = np.stack([_frames(48, 64, s) for s in range(2)])
    cfg = V.VideoCodecConfig()
    het = V.encode_chunk_ladder_batched(frames, [[48, 64]] * 2, [50.0] * 2,
                                        cfg, device="cpu")
    hom = V.encode_chunk_batched(frames, cfg, device="cpu")
    for k in ENC_FIELDS:
        assert torch.equal(getattr(het, k), getattr(hom, k)), k


def test_decode_chunk_and_chunk_psnr_match_reference():
    frames = _frames(48, 64, 3)
    enc = V.encode_chunk(frames, V.VideoCodecConfig(), device="cpu")
    assert V.decode_chunk(enc) is enc.recon
    jenc = JV.encode_chunk(jnp.asarray(frames), JV.VideoCodecConfig())
    ours = V.chunk_psnr(_t(frames), V.decode_chunk(enc))
    ref = JV.chunk_psnr(jnp.asarray(frames), JV.decode_chunk(jenc))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3)
    both = V.chunk_psnr(_t(np.stack([frames, frames])),
                        torch.stack([enc.recon, enc.recon]))
    assert both.shape == (2, T) and torch.equal(both[1], ours)


# -------------------------------------------------- decode side, extents
@pytest.fixture(scope="module")
def ladder_encoded(ladder_chunks):
    jf, je = JV.pad_ladder_batch([jnp.asarray(c) for c in ladder_chunks])
    enc = JV.encode_chunk_ladder_batched(
        jf, je, jnp.asarray(LADDER_QUALITIES, jnp.float32),
        JV.VideoCodecConfig())
    return np.asarray(enc.mv), np.asarray(enc.residual_q), np.asarray(je)


@pytest.mark.parametrize("roi", [R.RoiConfig(), R.RoiConfig(region_px=16),
                                 R.RoiConfig(w_motion=0.5, w_resid=2.0)])
def test_region_scores_with_extent_match_reference(ladder_encoded, roi):
    mv, rq, ext = ladder_encoded
    jroi = JROI.RoiConfig(**dataclasses.asdict(roi))
    ours = R.region_scores(_t(mv), _t(rq), (64, 96), (HH, WW), roi,
                           lr_extent=_t(ext))
    for s in range(3):
        ref = JROI.region_scores(jnp.asarray(mv[s]), jnp.asarray(rq[s]),
                                 (64, 96), (HH, WW), jroi,
                                 lr_extent=(int(ext[s, 0]), int(ext[s, 1])))
        np.testing.assert_array_equal(ours[s].numpy(), np.asarray(ref))
        one = R.region_scores(_t(mv[s]), _t(rq[s]), (64, 96), (HH, WW), roi,
                              lr_extent=tuple(ext[s]))
        assert torch.equal(one, ours[s])


@pytest.mark.parametrize("hw", [(96, 144), (720, 1280)])
def test_upscale_mvs_with_extent_match_reference(ladder_encoded, hw):
    mv, _, ext = ladder_encoded
    ours = H._upscale_mvs(_t(mv), hw, lr_hw=_t(ext))
    for s in range(3):
        ref = JH._upscale_mvs(jnp.asarray(mv[s]), hw,
                              lr_hw=(jnp.int32(ext[s, 0]),
                                     jnp.int32(ext[s, 1])))
        np.testing.assert_array_equal(ours[s].numpy(), np.asarray(ref))


def test_upscale_nearest_with_stream_extents_matches_reference():
    rng = np.random.default_rng(4)
    lr = rng.uniform(0, 255, (2, 3, 48, 64)).astype(np.float32)
    ext = np.array([[32, 48], [48, 64]], np.int32)
    from repro_torch.codec.rate_model import upscale_nearest
    ours = upscale_nearest(_t(lr), HH, WW, src_hw=_t(ext))
    for s in range(2):
        np.testing.assert_array_equal(ours[s].numpy(), np.asarray(
            JR.upscale_nearest(jnp.asarray(lr[s]), HH, WW,
                               src_hw=tuple(ext[s]))))


def _hold_outputs(ours: dict, ref: dict, label=""):
    """The contract of test_torch_roundtrip.py for roundtrip_chunk."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = {k: v.numpy() for k, v in ours.items()}
    assert set(ours) == set(ref), label
    for k in ("types", "anchor_q"):
        if k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=label + k)
    for k in ("video_bits", "anchor_bits", "total_bits"):
        if k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4,
                                       err_msg=label + k)
    np.testing.assert_allclose(ours["scores"], ref["scores"], atol=1e-4,
                               err_msg=label)
    np.testing.assert_allclose(ours["boxes"], ref["boxes"], atol=1e-2,
                               err_msg=label)
    for k in ("f1", "mean_f1"):
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6,
                                   err_msg=label + k)
    for k in ("latency", "t_trans", "t_comp", "t_queue"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5,
                                   err_msg=label + k)


@pytest.mark.parametrize("roi", [None, R.RoiConfig(capacity=3)],
                         ids=["full", "roi"])
def test_decode_execute_batched_matches_reference(streams, jparams, params,
                                                  roi):
    raw, gtb, gtv = streams
    lr = np.stack([np.asarray(JR.downscale(jnp.asarray(raw[s]), 2 / 3))
                   for s in range(3)])
    jenc = JV.encode_chunk_batched(jnp.asarray(lr), JV.VideoCodecConfig())
    enc = V.EncodedChunk(**{k: _t(getattr(jenc, k)) for k in ENC_FIELDS})
    types = np.array([[1, 3, 2, 3], [1, 2, 2, 1], [1, 3, 3, 3]], np.int32)
    anchor = np.where(types[..., None, None] == 1, raw, 0.0) \
        .astype(np.float32)
    sc = dict(bw_kbps=np.array([6000.0, 900.0, 3000.0], np.float32),
              queue_delay=np.array([0.0, 0.05, 0.01], np.float32),
              total_bits=np.array([1e4, 2e4, 3e4], np.float32))
    ours = H.decode_execute_batched(enc, types, anchor, gtb, gtv, params,
                                    H.D.TinyDetectorConfig(), roi=roi,
                                    device="cpu", **sc)
    jroi = None if roi is None else JROI.RoiConfig(
        **dataclasses.asdict(roi))
    ref = JH.decode_execute_batched(jenc, jnp.asarray(types),
                                    jnp.asarray(anchor), jnp.asarray(gtb),
                                    jnp.asarray(gtv), jparams,
                                    JD.TinyDetectorConfig(), roi=jroi, **sc)
    _hold_outputs(ours, ref)
    # each lane is the single-stream decode of that stream, bit for bit
    for s in range(3):
        one = H.decode_execute_chunk(
            enc.lane(s), types[s], anchor[s], gtb[s], gtv[s], params,
            H.D.TinyDetectorConfig(), bw_kbps=float(sc["bw_kbps"][s]),
            queue_delay=float(sc["queue_delay"][s]),
            total_bits=float(sc["total_bits"][s]), roi=roi, device="cpu")
        for k in one:
            assert torch.equal(ours[k][s], one[k]), (s, k)


# ----------------------------------------------------------- round trips
def _single(raw, gtb, gtv, params, sc, s, cfg):
    return RT.roundtrip_chunk(
        raw[s], gtb[s], gtv[s], params, tr1=float(sc["tr1"][s]),
        tr2=float(sc["tr2"][s]), bw_kbps=float(sc["bw_kbps"][s]),
        queue_delay=float(sc["queue_delay"][s]), cfg=cfg, device="cpu")


def _hold_lanes_bit_exact(out, singles, label):
    for s, one in enumerate(singles):
        assert set(out) == set(one)
        for k in one:
            assert torch.equal(out[k][s], one[k]), f"{label} lane {s}: {k}"


def _padded_inputs(raw, levels):
    hp, wp = RT.full_lr_canvas(HH, WW)
    lr_pad, ext, qual = [], [], []
    for s, level in enumerate(levels):
        lr = downscale(_t(raw[s]), QUALITY_LADDER[level].scale)
        h, w = ladder_lr_shape(level, HH, WW)
        lr_pad.append(torch.nn.functional.pad(lr, (0, wp - w, 0, hp - h)))
        ext.append((h, w))
        qual.append(QUALITY_LADDER[level].quality)
    return torch.stack(lr_pad), torch.tensor(ext, dtype=torch.int32), \
        torch.tensor(qual)


ROUNDTRIP_CFGS = {
    "default": RT.RoundtripConfig(level=3),
    "roi": RT.RoundtripConfig(level=3, roi=R.RoiConfig(capacity=3),
                              codec=V.VideoCodecConfig(search="diamond",
                                                       dtype="bfloat16")),
}


def _jcfg(cfg):
    roi = None if cfg.roi is None else JROI.RoiConfig(
        **dataclasses.asdict(cfg.roi))
    codec = JV.VideoCodecConfig(**dataclasses.asdict(cfg.codec))
    return JRT.RoundtripConfig(level=cfg.level, roi=roi, codec=codec,
                               anchor_search=cfg.anchor_search)


@pytest.mark.parametrize("name", list(ROUNDTRIP_CFGS))
def test_roundtrip_batched_matches_reference_and_own_lanes(streams, jparams,
                                                           params, name):
    raw, gtb, gtv = streams
    cfg, sc = ROUNDTRIP_CFGS[name], _scalars()
    out = RT.roundtrip_batched(raw, gtb, gtv, params, cfg=cfg, device="cpu",
                               **sc)
    ref = JRT.roundtrip_batched(raw, gtb, gtv, jparams, cfg=_jcfg(cfg), **sc)
    _hold_outputs(out, ref, f"{name}: ")
    _hold_lanes_bit_exact(out, [_single(raw, gtb, gtv, params, sc, s, cfg)
                                for s in range(3)], name)


@pytest.mark.parametrize("name", list(ROUNDTRIP_CFGS))
def test_roundtrip_ladder_batched_matches_reference_and_own_lanes(
        streams, jparams, params, name):
    raw, gtb, gtv = streams
    cfg, sc = ROUNDTRIP_CFGS[name], _scalars()
    out = RT.roundtrip_ladder_batched(raw, gtb, gtv, params,
                                      levels=MIXED_LEVELS, cfg=cfg,
                                      device="cpu", **sc)
    ref = JRT.roundtrip_ladder_batched(raw, gtb, gtv, jparams,
                                       levels=MIXED_LEVELS, cfg=_jcfg(cfg),
                                       **sc)
    _hold_outputs(out, ref, f"{name}: ")
    _hold_lanes_bit_exact(out, [
        _single(raw, gtb, gtv, params, sc, s,
                dataclasses.replace(cfg, level=level))
        for s, level in enumerate(MIXED_LEVELS)], name)


@pytest.mark.parametrize("name", list(ROUNDTRIP_CFGS))
def test_roundtrip_padded_batched_matches_reference_and_own_lanes(
        streams, jparams, params, name):
    raw, gtb, gtv = streams
    cfg, sc = ROUNDTRIP_CFGS[name], _scalars()
    lr_pad, ext, qual = _padded_inputs(raw, MIXED_LEVELS)
    out = RT.roundtrip_padded_batched(raw, lr_pad, ext, qual, gtb, gtv,
                                      params, cfg=cfg, device="cpu", **sc)
    ref = JRT.roundtrip_padded_batched(
        raw, jnp.asarray(lr_pad.numpy()), jnp.asarray(ext.numpy()),
        jnp.asarray(qual.numpy()), gtb, gtv, jparams, cfg=_jcfg(cfg), **sc)
    _hold_outputs(out, ref, f"{name}: ")
    _hold_lanes_bit_exact(out, [
        _single(raw, gtb, gtv, params, sc, s,
                dataclasses.replace(cfg, level=level))
        for s, level in enumerate(MIXED_LEVELS)], name)


def test_ladder_batch_arrays_and_full_lr_canvas_match_reference():
    for hw in ((64, 96), (720, 1280)):
        assert RT.full_lr_canvas(*hw) == JRT.full_lr_canvas(*hw)
        ext, qual = RT.ladder_batch_arrays(MIXED_LEVELS + (0, 1), *hw,
                                           device="cpu")
        jext, jqual = JRT.ladder_batch_arrays(MIXED_LEVELS + (0, 1), *hw)
        np.testing.assert_array_equal(ext.numpy(), np.asarray(jext))
        np.testing.assert_array_equal(qual.numpy(), np.asarray(jqual))
        assert ext.dtype == torch.int32 and qual.dtype == torch.float32


# ---------------------------------------------------------- video source
def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("n", [1, 2, 9])
def test_paper_stream_mix_matches_reference(n):
    for hw in ((96, 160), (720, 1280)):
        ours = S.paper_stream_mix(n, *hw)
        ref = JS.paper_stream_mix(n, *hw)
        assert [_fields(c) for c in ours] == [_fields(c) for c in ref]
        assert [c.batch_signature for c in ours] == \
            [c.batch_signature for c in ref]


@pytest.mark.parametrize("scenario", ["sparse-highway", "crowded-crossroad",
                                      "day-night-mix"])
def test_scenario_streams_match_reference(scenario):
    ours = S.scenario_streams(scenario, 4, 64, 96)
    ref = JS.scenario_streams(scenario, 4, 64, 96)
    assert [_fields(c) for c in ours] == [_fields(c) for c in ref]
    with pytest.raises(ValueError, match="unknown scenario"):
        S.scenario_streams("rainy-bridge")


def test_group_by_signature_matches_reference():
    mix = S.paper_stream_mix(9) + S.scenario_streams("day-night-mix", 3) \
        + S.paper_stream_mix(2, 64, 96)
    jmix = JS.paper_stream_mix(9) + JS.scenario_streams("day-night-mix", 3) \
        + JS.paper_stream_mix(2, 64, 96)
    ours = S.group_by_signature(mix)
    assert ours == JS.group_by_signature(jmix)
    assert list(ours) == [(96, 160, 3), (96, 160, 12), (96, 160, 6),
                          (64, 96, 3), (64, 96, 12)]


@pytest.mark.parametrize("t0", [0, 7])
def test_generate_chunk_batched_lanes_equal_generate_chunk(t0):
    mix = S.paper_stream_mix(5, 48, 80)
    for sig, idx in S.group_by_signature(mix).items():
        cfgs = [mix[i] for i in idx]
        frames, boxes, valid = S.generate_chunk_batched(cfgs, t0, 3,
                                                        device="cpu")
        assert frames.shape == (len(cfgs), 3, 48, 80)
        assert boxes.shape == (len(cfgs), 3, sig[2], 4)
        for s, cfg in enumerate(cfgs):
            f, b, v = S.generate_chunk(cfg, t0, 3, device="cpu")
            assert torch.equal(frames[s], f) and torch.equal(boxes[s], b)
            assert torch.equal(valid[s], v)
    with pytest.raises(ValueError, match="one shape signature"):
        S.generate_chunk_batched(mix[:2], 0, 3, device="cpu")


# ------------------------------------------------- CUDA unless told the CPU
def test_batched_entry_points_default_to_cuda_and_raise_without_it(
        streams, params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw, gtb, gtv = streams
    sc = _scalars()
    lr_pad, ext, qual = _padded_inputs(raw, MIXED_LEVELS)
    frames = np.stack([_frames(48, 64, s) for s in range(2)])
    enc = V.encode_chunk_batched(frames, device="cpu")
    types = np.ones((2, T), np.int32)
    calls = [
        lambda: V.encode_chunk_batched(frames),
        lambda: V.encode_chunk_ladder_batched(frames, [[48, 64]] * 2,
                                              [50.0] * 2),
        lambda: V.pad_ladder_batch(list(frames)),
        lambda: H.decode_execute_batched(
            enc, types, raw[:2], gtb[:2], gtv[:2], params,
            H.D.TinyDetectorConfig(), bw_kbps=6000.0, queue_delay=0.0,
            total_bits=1e4),
        lambda: RT.roundtrip_batched(raw, gtb, gtv, params, **sc),
        lambda: RT.roundtrip_ladder_batched(raw, gtb, gtv, params,
                                            levels=MIXED_LEVELS, **sc),
        lambda: RT.roundtrip_padded_batched(raw, lr_pad, ext, qual, gtb,
                                            gtv, params, **sc),
        lambda: RT.ladder_batch_arrays(MIXED_LEVELS, HH, WW),
        lambda: S.generate_chunk_batched(S.paper_stream_mix(1), 0, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
