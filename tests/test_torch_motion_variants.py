"""The port's diamond and bf16 motion searches, the codec that runs them,
and the bf16 storage variant of ``qtransfer``, on the CPU against the JAX
package at 64x96 on the same numpy inputs.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against
these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import motion as JM
from repro.codec.rate_model import downscale as j_downscale
from repro.codec.video_codec import VideoCodecConfig as JVideoCodecConfig
from repro.codec.video_codec import encode_chunk as j_encode_chunk
from repro.kernels.motion_sad.ops import motion_sad as j_motion_sad_kernel
from repro.kernels.qtransfer.ops import qtransfer as j_qtransfer
from repro.sim.video_source import StreamConfig as JStreamConfig
from repro.sim.video_source import generate_chunk as j_generate_chunk
from repro_torch.codec import motion as M
from repro_torch.codec.video_codec import VideoCodecConfig, encode_chunk
from repro_torch.kernels.motion_sad.ops import (launch_name, motion_sad,
                                                motion_sad_diamond_plain,
                                                motion_sad_plain)
from repro_torch.kernels.qtransfer.ops import qtransfer, qtransfer_plain

BF16 = {None: None, "bf16": torch.bfloat16}
J_BF16 = {None: None, "bf16": jnp.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _frames(seed, H, W, integer):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H + 16, W + 16))
    ref = base[8:8 + H, 8:8 + W]
    cur = base[5:5 + H, 10:10 + W] + rng.normal(0, 3, (H, W))
    if integer:
        cur, ref = np.round(cur), np.round(ref)
    return cur.astype(np.float32), ref.astype(np.float32)


def _stored(a, dtype):
    """The frame as the search sees it: rounded to bf16 where asked."""
    return a if dtype is None else \
        np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _sad_f64(cur, ref, by, bx, dy, dx):
    H, W = ref.shape
    ys = np.clip(np.arange(by * 16, by * 16 + 16) + dy, 0, H - 1)
    xs = np.clip(np.arange(bx * 16, bx * 16 + 16) + dx, 0, W - 1)
    c = cur[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16].astype(np.float64)
    return np.abs(c - ref[np.ix_(ys, xs)].astype(np.float64)).sum()


# ------------------------------------------------------- schedule, exact
@pytest.mark.parametrize("radius", range(1, 17))
def test_diamond_steps_and_num_evals_match(radius):
    assert M.diamond_steps(radius) == JM.diamond_steps(radius)
    assert M.diamond_num_evals(radius) == JM.diamond_num_evals(radius)


# ------------------------------------------------ the searches vs block_sad
VARIANTS = [("exhaustive", "bf16"), ("diamond", None), ("diamond", "bf16")]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("radius", [4, 8])
@pytest.mark.parametrize("search,dtype", VARIANTS)
def test_block_sad_variants_match_reference(search, dtype, radius, integer):
    """Integer frames: MVs and SADs exact (every sum is exact in f32).
    Float frames: MVs exact, or different only where the reference's SADs
    of the two picks agree in f64 within 1e-5 relative; SADs of equal
    picks within rtol 1e-5 (the sums run in another order)."""
    cur, ref = _frames(10 + radius, 64, 96, integer)
    mv, sad = M.block_sad(_t(cur), _t(ref), radius, dtype=BF16[dtype],
                          search=search)
    jmv, jsad = (np.asarray(a) for a in JM.block_sad(
        jnp.asarray(cur), jnp.asarray(ref), radius, dtype=J_BF16[dtype],
        search=search))
    mv, sad = mv.numpy(), sad.numpy()
    assert mv.dtype == np.int32 and mv.shape == (4, 6, 2)
    if integer:
        np.testing.assert_array_equal(mv, jmv)
        np.testing.assert_array_equal(sad, jsad)
        return
    c, r = _stored(cur, dtype), _stored(ref, dtype)
    for by, bx in zip(*np.nonzero((mv != jmv).any(-1))):
        a = _sad_f64(c, r, by, bx, *mv[by, bx])
        b = _sad_f64(c, r, by, bx, *jmv[by, bx])
        assert abs(a - b) <= 1e-5 * max(a, b)
    same = (mv == jmv).all(-1)
    np.testing.assert_allclose(sad[same], jsad[same], rtol=1e-5)


@pytest.mark.parametrize("search,dtype", VARIANTS)
def test_plain_versions_match_the_pallas_kernel(search, dtype):
    """Integer frames through the reference's Pallas kernel in interpret
    mode, as its own tests run it: MVs and SADs exact."""
    cur, ref = _frames(3, 64, 96, integer=True)
    mv, sad = motion_sad(_t(cur), _t(ref), 8, dtype=BF16[dtype],
                         search=search)
    jmv, jsad = j_motion_sad_kernel(jnp.asarray(cur), jnp.asarray(ref),
                                    radius=8, interpret=True,
                                    dtype=J_BF16[dtype], search=search)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jmv))
    np.testing.assert_array_equal(sad.numpy(), np.asarray(jsad))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_diamond_sad_never_below_exhaustive(seed, dtype):
    """The diamond's probes are a subset of the exhaustive candidates and
    each SAD is the same expression, so its SAD is never lower; at (0, 0)
    it starts, so it is never above the zero-motion SAD either."""
    cur, ref = _frames(20 + seed, 64, 96, integer=seed % 2 == 0)
    dt = BF16[dtype]
    _, sad_d = M.block_sad_diamond(_t(cur), _t(ref), 8, dtype=dt)
    _, sad_e = M.block_sad(_t(cur), _t(ref), 8, dtype=dt)
    assert bool((sad_d >= sad_e).all())
    _, sad_0 = M.block_sad(_t(cur), _t(ref), 0, dtype=dt)
    assert bool((sad_d <= sad_0).all())


def test_bf16_storage_equals_f32_on_integer_frames():
    """Integers up to 256 are exact in bf16: on 8-bit frames the bf16
    variants must give the f32 variants' MVs and SADs."""
    cur, ref = (np.clip(a, 0, 255) for a in _frames(5, 64, 96, True))
    for plain in (motion_sad_plain, motion_sad_diamond_plain):
        mv, sad = plain(_t(cur), _t(ref), 8)
        mvb, sadb = plain(_t(cur), _t(ref), 8, dtype=torch.bfloat16)
        assert torch.equal(mv, mvb) and torch.equal(sad, sadb)


def test_motion_sad_wrapper_forms_and_checks():
    cur, ref = _frames(6, 32, 48, integer=True)
    mv, sad = motion_sad(_t(cur), _t(ref), 4, search="diamond")
    mv_o, sad_o = M.block_sad_diamond(_t(cur), _t(ref), 4)
    assert torch.equal(mv, mv_o) and torch.equal(sad, sad_o)
    assert [launch_name(s, d) for s in ("exhaustive", "diamond")
            for d in (None, torch.bfloat16)] == [
        "motion_sad", "motion_sad_bf16", "motion_sad_diamond",
        "motion_sad_diamond_bf16"]
    assert launch_name("exhaustive", torch.float32) == "motion_sad"
    with pytest.raises(ValueError, match="unknown search"):
        M.block_sad(_t(cur), _t(ref), 4, search="spiral")
    with pytest.raises(ValueError, match="unknown search"):
        motion_sad(_t(cur), _t(ref), 4, search="spiral")
    with pytest.raises(ValueError, match="storage dtype"):
        motion_sad(_t(cur), _t(ref), 4, dtype=torch.float16)


# ---------------------------------------------------------- video codec
@pytest.fixture(scope="module")
def lr_frames():
    raw, _, _ = j_generate_chunk(None, JStreamConfig(height=64, width=96,
                                                     n_objects=3, seed=0),
                                 0, 4)
    return np.array(j_downscale(jnp.asarray(raw, jnp.float32), 2 / 3))


@pytest.mark.parametrize("search,dtype", [("diamond", "bfloat16"),
                                          ("diamond", "float32"),
                                          ("exhaustive", "bf16")])
def test_encode_chunk_variants_match(lr_frames, search, dtype):
    """The codec with each search variant: MVs exact, the bit proxy and
    the features within rtol 1e-4 (f32 sums in other orders)."""
    ref = j_encode_chunk(jnp.asarray(lr_frames), JVideoCodecConfig(
        search=search, dtype=dtype))
    ours = encode_chunk(lr_frames, VideoCodecConfig(search=search,
                                                    dtype=dtype),
                        device="cpu")
    np.testing.assert_array_equal(ours.mv.numpy(), np.asarray(ref.mv))
    for k in ("bits", "residual_mag", "frame_diff"):
        np.testing.assert_allclose(getattr(ours, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(ours.recon.numpy(), np.asarray(ref.recon),
                               atol=1e-3)


def test_codec_config_search_dtype_and_unknown_search(lr_frames):
    assert VideoCodecConfig(dtype="bfloat16").search_dtype == torch.bfloat16
    assert VideoCodecConfig(dtype="bf16").search_dtype == torch.bfloat16
    assert VideoCodecConfig().search_dtype is None
    for dt in ("float32", "bfloat16", "bf16"):
        assert (VideoCodecConfig(dtype=dt).search_dtype is None) == \
            (JVideoCodecConfig(dtype=dt).search_dtype is None)
    with pytest.raises(ValueError, match="unknown search"):
        encode_chunk(lr_frames, VideoCodecConfig(search="spiral"),
                     device="cpu")


# ------------------------------------------------------ qtransfer bf16
def _qt_inputs(seed, B, H, W, max_mv):
    rng = np.random.default_rng(seed)
    anchor = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    mv = rng.integers(-max_mv, max_mv + 1, (B, H // 16, W // 16, 2)) \
        .astype(np.int32)
    resid = rng.normal(0, 8, (B, H, W)).astype(np.float32)
    return anchor, mv, resid


@pytest.mark.parametrize("H,W,radius", [(64, 96, 8), (64, 96, 16),
                                        (48, 160, 8)])
def test_qtransfer_bf16_matches_kernel_exactly(H, W, radius):
    """bf16 storage: exact against the reference's Pallas kernel in
    interpret mode (both gather and add in f32 and round once)."""
    anchor, mv, resid = _qt_inputs(11, 2, H, W, radius + 4)
    out = qtransfer_plain(_t(anchor), torch.from_numpy(mv), _t(resid),
                          edge="block", radius=radius, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = j_qtransfer(jnp.asarray(anchor), jnp.asarray(mv),
                      jnp.asarray(resid), radius=radius, interpret=True,
                      dtype=jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_qtransfer_bf16_wrapper_routes_and_checks():
    anchor, mv, resid = _qt_inputs(12, 1, 64, 96, 16)
    a, m, r = _t(anchor), torch.from_numpy(mv), _t(resid)
    bf = torch.bfloat16
    out = qtransfer(a, m, r, edge="block", dtype=bf)
    assert torch.equal(out, qtransfer_plain(a, m, r, edge="block", dtype=bf))
    # the f32 form is unchanged by the dtype argument's default
    assert torch.equal(qtransfer(a, m, r, edge="block"),
                       qtransfer_plain(a, m, r, edge="block"))
    with pytest.raises(ValueError, match="block edge mode only"):
        qtransfer(a, m, r, edge="pixel", dtype=bf)
    with pytest.raises(ValueError, match="storage dtype"):
        qtransfer(a, m, r, edge="block", dtype=torch.float16)
