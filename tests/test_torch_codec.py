"""The port's codec (``repro_torch.codec``) and Eq. 3 classification on the
CPU, against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import blockdct as JB
from repro.codec import image_codec as JI
from repro.codec import motion as JM
from repro.codec import rate_model as JR
from repro.codec.video_codec import VideoCodecConfig as JVideoCodecConfig
from repro.codec.video_codec import encode_chunk as j_encode_chunk
from repro.core.classification import classify_frames as j_classify
from repro.sim.video_source import StreamConfig as JStreamConfig
from repro.sim.video_source import generate_chunk as j_generate_chunk
from repro_torch.codec import blockdct as B
from repro_torch.codec import image_codec as I
from repro_torch.codec import motion as M
from repro_torch.codec import rate_model as R
from repro_torch.codec.video_codec import VideoCodecConfig, encode_chunk
from repro_torch.core.classification import classify_frames

H, W, T = 64, 96, 4


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


@pytest.fixture(scope="module")
def frames():
    raw, _, _ = j_generate_chunk(None, JStreamConfig(height=H, width=W,
                                                     n_objects=3, seed=0),
                                 0, T)
    return np.asarray(raw, np.float32)


# -------------------------------------------------------------- rate model
def test_ladder_tables_match():
    assert [dataclass_tuple(q) for q in R.QUALITY_LADDER] == \
        [dataclass_tuple(q) for q in JR.QUALITY_LADDER]
    for level in range(5):
        for hw in ((64, 96), (720, 1280), (100, 70)):
            assert R.ladder_lr_shape(level, *hw) == JR.ladder_lr_shape(
                level, *hw)


def dataclass_tuple(q):
    return (q.name, q.bitrate_kbps, q.scale, q.quality)


@pytest.mark.parametrize("scale", [0.25, 1 / 3, 0.5, 2 / 3, 1.0])
def test_downscale_matches(frames, scale):
    ours = R.downscale(_t(frames), scale).numpy()
    ref = np.asarray(JR.downscale(jnp.asarray(frames), scale))
    np.testing.assert_allclose(ours, ref, atol=1e-4)   # mean's sum order


@pytest.mark.parametrize("src_hw", [None, (40, 48)])
def test_upscale_nearest_exact(frames, src_hw):
    lr = frames[:, :48, :64]
    ours = R.upscale_nearest(_t(lr), H, W, src_hw=src_hw).numpy()
    ref = np.asarray(JR.upscale_nearest(jnp.asarray(lr), H, W,
                                        src_hw=src_hw))
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------- blockdct
@pytest.mark.parametrize("quality", [1.0, 20.0, 50.0, 70.0, 95.0, 120.0])
def test_quant_table_exact(quality):
    np.testing.assert_array_equal(B.quant_table(quality).numpy(),
                                  np.asarray(JB.quant_table(quality)))
    np.testing.assert_array_equal(B.dct_matrix().numpy(), JB.dct_matrix(8))


def test_blockify_roundtrip_and_transforms(frames):
    blocks = B.blockify(_t(frames[0]))
    np.testing.assert_array_equal(blocks.numpy(),
                                  np.asarray(JB.blockify(frames[0])))
    np.testing.assert_array_equal(B.unblockify(blocks, H, W).numpy(),
                                  frames[0])
    batched = B.blockify(_t(frames))               # (T, nb, 8, 8)
    np.testing.assert_array_equal(batched[2].numpy(), B.blockify(
        _t(frames[2])).numpy())
    np.testing.assert_allclose(B.dct2(blocks).numpy(),
                               np.asarray(JB.dct2(jnp.asarray(blocks))),
                               atol=1e-3)
    np.testing.assert_allclose(B.idct2(blocks).numpy(),
                               np.asarray(JB.idct2(jnp.asarray(blocks))),
                               atol=1e-3)
    qt = B.quant_table(50.0)
    q = B.quantize_with_table(B.dct2(blocks - 128.0), qt)
    jq = JB.quantize_with_table(JB.dct2(jnp.asarray(blocks) - 128.0),
                                jnp.asarray(qt.numpy()))
    assert float(np.abs(q.numpy() - np.asarray(jq)).max()) <= 1.0
    np.testing.assert_array_equal(B.dequantize(q, qt).numpy(),
                                  np.asarray(JB.dequantize(q.numpy(),
                                                           qt.numpy())))
    # the codec's fused entry equals the separate steps on the CPU
    q2, rec = B.dct_quantize(blocks - 128.0, qt)
    assert torch.equal(q2, q)
    torch.testing.assert_close(rec, B.idct2(B.dequantize(q, qt)))
    torch.testing.assert_close(B.dequant_idct(q, qt), rec)


def test_entropy_bits_and_seq_sum():
    q = np.round(np.random.default_rng(0).normal(0, 3, (96, 8, 8))) \
        .astype(np.float32)
    ours = B.entropy_bits(_t(q), grid=(8, 12))
    ref = JB.entropy_bits(jnp.asarray(q), grid=(8, 12))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(B.entropy_bits(_t(q))),
                               float(JB.entropy_bits(jnp.asarray(q))),
                               rtol=1e-5)
    grid = np.random.default_rng(1).uniform(0, 10, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(float(B.seq_sum(_t(grid))),
                               float(JB.seq_sum(jnp.asarray(grid))),
                               rtol=1e-6)


@pytest.mark.parametrize("quality", [50.0, 70.0])
def test_jpeg_encode_decode_matches(frames, quality):
    rec, bits = I.jpeg_encode_decode(_t(frames), quality)   # one batch
    for t in range(T):
        rr, rb = JI.jpeg_encode_decode(jnp.asarray(frames[t]), quality)
        # a coefficient that rounds the other way at a .5 boundary moves
        # its block; none does on these frames
        np.testing.assert_allclose(rec[t].numpy(), np.asarray(rr), atol=1e-3)
        np.testing.assert_allclose(float(bits[t]), float(rb), rtol=1e-5)
        assert abs(float(I.psnr(_t(frames[t]), rec[t]))
                   - float(JI.psnr(jnp.asarray(frames[t]), rr))) < 1e-3


# ------------------------------------------------------------------ motion
def test_block_sad_scan_and_block_sad_match_reference(frames):
    # integer-valued frames: every SAD is exact, so the picks are equal
    cur, ref = np.round(frames[1]), np.round(frames[0])
    jmv, jsad = (np.asarray(a) for a in JM.block_sad_scan(
        jnp.asarray(cur), jnp.asarray(ref), 8))
    for fn in (M.block_sad_scan, M.block_sad):
        mv, sad = fn(_t(cur), _t(ref), 8)
        np.testing.assert_array_equal(mv.numpy(), jmv)
        np.testing.assert_array_equal(sad.numpy(), jsad)
    with pytest.raises(ValueError, match="unknown search"):
        M.block_sad(_t(cur), _t(ref), 8, search="spiral")


@pytest.mark.parametrize("search", ["exhaustive", "diamond"])
def test_block_sad_matches_reference_at_the_lr_shape(search):
    """The main path's LR shape, 352x640 at R=8: integer-valued frames
    (every SAD exact), a frame and its shifted, noisier successor."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (352 + 32, 640 + 32))
    ref = np.round(base[16:368, 16:656]).astype(np.float32)
    noisy = base[13:365, 18:658] + rng.normal(0, 3, (352, 640))
    cur = np.clip(np.round(noisy), 0, 255).astype(np.float32)
    if search == "exhaustive":
        jmv, jsad = JM.block_sad_scan(jnp.asarray(cur), jnp.asarray(ref), 8)
    else:
        jmv, jsad = JM.block_sad(jnp.asarray(cur), jnp.asarray(ref), 8,
                                 search="diamond")
    mv, sad = M.block_sad(_t(cur), _t(ref), 8, search=search)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jmv))
    np.testing.assert_array_equal(sad.numpy(), np.asarray(jsad))


def test_warp_blocks_exact(frames):
    mv = np.random.default_rng(2).integers(-24, 25, (H // 16, W // 16, 2)) \
        .astype(np.int32)
    ours = M.warp_blocks(_t(frames[0]), _t(mv)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(JM.warp_blocks(jnp.asarray(frames[0]),
                                        jnp.asarray(mv))))


# ------------------------------------------------------------- video codec
@pytest.mark.parametrize("quality", [50.0, 65.0])
def test_encode_chunk_matches(frames, quality):
    lr = np.array(JR.downscale(jnp.asarray(frames), 2 / 3))
    ref = j_encode_chunk(jnp.asarray(lr), JVideoCodecConfig(quality=quality))
    ours = encode_chunk(lr, VideoCodecConfig(quality=quality), device="cpu")
    # the SADs are f32 sums in another order, so a near-tie could pick
    # another MV; on these frames no pick differs, which is tighter than
    # the equal-SAD contract of tests/test_torch_kernels_plain.py
    np.testing.assert_array_equal(ours.mv.numpy(), np.asarray(ref.mv))
    dq = np.abs(ours.residual_q.numpy() - np.asarray(ref.residual_q))
    assert dq.max() <= 1.0
    # recon agrees outside the 8x8 blocks where a coefficient flipped
    flip = (dq > 0).any(axis=(2, 3))                    # (T, nb)
    ok = ~B.unblockify(_t(np.broadcast_to(flip[..., None, None],
                                          (*flip.shape, 8, 8))),
                       *lr.shape[1:]).numpy()
    np.testing.assert_allclose(ours.recon.numpy()[ok],
                               np.asarray(ref.recon)[ok], atol=1e-3)
    np.testing.assert_array_equal(ours.qtab.numpy(), np.asarray(ref.qtab))
    for k in ("bits", "residual_mag", "frame_diff"):
        np.testing.assert_allclose(getattr(ours, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------- classification
@pytest.mark.parametrize("tr1,tr2", [(0.05, 0.1), (0.5, 0.02), (1.0, 0.0),
                                     (0.0, 0.0)])
def test_classify_frames_exact(tr1, tr2):
    rng = np.random.default_rng(3)
    fd = rng.uniform(0, 0.05, 30).astype(np.float32)
    rm = rng.uniform(0, 0.03, 30).astype(np.float32)
    types, X, Rr = classify_frames(_t(fd), _t(rm), tr1, tr2)
    jt, jX, jR = (np.asarray(a) for a in j_classify(jnp.asarray(fd),
                                                    jnp.asarray(rm),
                                                    tr1, tr2))
    np.testing.assert_array_equal(types.numpy(), jt)
    np.testing.assert_array_equal(X.numpy(), jX)
    np.testing.assert_array_equal(Rr.numpy(), jR)
    assert types.dtype == torch.int32
