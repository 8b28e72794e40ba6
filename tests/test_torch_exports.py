"""The reference's public package names in the port, each held against
the reference on the same numpy inputs: the ``codec`` and ``core``
exports, the kernel packages' entries (``blockdct_quantize``,
``flash_attention``, ``qtransfer``, ``roi_gather``, ``roi_gather_ref``)
and the codec helpers at the reference's paths.

Contracts: integer, gather and host outputs exactly; reconstructions
within the blockdct contract (1e-3 px, a quantised coefficient within 1
where a product rounds across .5); bits rtol 1e-5; the attention within
the reference's tolerance for f32 inputs (0.02)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codec as JC
import repro.core as JCore
import repro_torch.codec as C
import repro_torch.core as Core
from repro.codec import blockdct as JB
from repro.codec import motion as JMo
from repro.kernels import blockdct as JKB
from repro.kernels import flash_attention as JKF
from repro.kernels import qtransfer as JKQ
from repro.kernels import roi_gather as JRG
from repro_torch.codec import blockdct as B
from repro_torch.codec import motion as Mo
from repro_torch.kernels import blockdct as KB
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import qtransfer as KQ
from repro_torch.kernels import roi_gather as RG

RNG = np.random.default_rng(0)
IMG = (RNG.random((32, 48)) * 255).astype(np.float32)
CHUNK = (RNG.random((4, 32, 48)) * 255).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jpeg_encode_decode():
    rec, bits = C.jpeg_encode_decode(_t(IMG), 60.0)
    jrec, jbits = JC.jpeg_encode_decode(jnp.asarray(IMG), 60.0)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=1e-3)
    np.testing.assert_allclose(float(bits), float(jbits), rtol=1e-5)


def _jpeg_bits():
    np.testing.assert_allclose(float(C.jpeg_bits(_t(IMG), 40.0)),
                               float(JC.jpeg_bits(jnp.asarray(IMG), 40.0)),
                               rtol=1e-5)


def _video_codec():
    ours = {f.name: f.default for f in dataclasses.fields(C.VideoCodecConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JC.VideoCodecConfig)}
    # the port routes by device: the reference's use_kernel has no field
    assert ours == {k: v for k, v in ref.items() if k != "use_kernel"}
    enc = C.encode_chunk(_t(CHUNK), C.VideoCodecConfig(), device="cpu")
    jenc = JC.encode_chunk(jnp.asarray(CHUNK), JC.VideoCodecConfig())
    np.testing.assert_array_equal(enc.mv.numpy(), np.asarray(jenc.mv))
    np.testing.assert_allclose(enc.bits.numpy(), np.asarray(jenc.bits),
                               rtol=1e-5)
    np.testing.assert_allclose(C.decode_chunk(enc).numpy(),
                               np.asarray(JC.decode_chunk(jenc)), atol=1e-3)


def _quality_ladder():
    assert [dataclasses.astuple(q) for q in C.QUALITY_LADDER] == \
        [dataclasses.astuple(q) for q in JC.QUALITY_LADDER]
    for bw in (100.0, 700.0, 2500.0, 6000.0, 40000.0):
        assert C.ladder_for_bandwidth(bw) == JC.ladder_for_bandwidth(bw)


def _classify_frames():
    fd = RNG.random(12).astype(np.float32) * 0.2
    rm = RNG.random(12).astype(np.float32) * 0.05
    ours = Core.classify_frames(_t(fd), _t(rm), 0.06, 0.015)
    ref = JCore.classify_frames(jnp.asarray(fd), jnp.asarray(rm), 0.06,
                                0.015)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _fairness():
    r = RNG.random(9).astype(np.float32)
    assert float(Core.min_reward_fairness(_t(r))) == \
        float(JCore.min_reward_fairness(jnp.asarray(r)))
    np.testing.assert_allclose(float(Core.jain_index(_t(r))),
                               float(JCore.jain_index(jnp.asarray(r))),
                               rtol=1e-6)


def _blockdct_quantize():
    blocks = (RNG.random((6, 8, 8)) * 255 - 128).astype(np.float32)
    q, rec = KB.blockdct_quantize(_t(blocks), 70.0)
    jq, jrec = JKB.blockdct_quantize(jnp.asarray(blocks), 70.0)
    assert np.abs(q.numpy() - np.asarray(jq)).max() <= 1
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=1e-3)


def _flash_attention():
    q, k, v = (RNG.normal(0, 1, s).astype(np.float32)
               for s in ((1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)))
    ours = KF.flash_attention(_t(q), _t(k), _t(v), causal=True)
    ref = JKF.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=True, q_blk=64, k_blk=64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=0.02)


def _qtransfer():
    anchor = (RNG.random((2, 32, 48)) * 255).astype(np.float32)
    resid = RNG.normal(0, 4, (2, 32, 48)).astype(np.float32)
    mv = RNG.integers(-20, 21, (2, 2, 3, 2)).astype(np.int32)
    ours = KQ.qtransfer(_t(anchor), _t(mv), _t(resid), edge="block",
                        radius=16)
    ref = JKQ.qtransfer(jnp.asarray(anchor), jnp.asarray(mv),
                        jnp.asarray(resid), radius=16)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _roi_gather_ref():
    planes = RNG.random((2, 40, 56)).astype(np.float32)
    ry = RNG.integers(-1, 5, (2, 3)).astype(np.int32)
    rx = RNG.integers(-1, 7, (2, 3)).astype(np.int32)
    ref = JRG.roi_gather_ref(jnp.asarray(planes), jnp.asarray(ry),
                             jnp.asarray(rx), region_px=8, halo=4)
    assert RG.__all__ == JRG.__all__
    for fn in (RG.roi_gather_ref, RG.roi_gather):
        ours = fn(_t(planes), _t(ry), _t(rx), region_px=8, halo=4)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _codec_helpers():
    blocks = B.blockify(_t(IMG))
    np.testing.assert_array_equal(blocks.numpy(),
                                  np.asarray(JB.blockify(jnp.asarray(IMG))))
    np.testing.assert_array_equal(B.unblockify(blocks, 32, 48).numpy(), IMG)
    coefs = (RNG.normal(0, 60, (5, 8, 8))).astype(np.float32)
    for quality in (10.0, 50.0, 95.0):
        q, qtab = B.quantize(_t(coefs), quality)
        jq, jqtab = JB.quantize(jnp.asarray(coefs), quality)
        np.testing.assert_array_equal(qtab.numpy(), np.asarray(jqtab))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    for r in (0, 1, 2, 7, 8, 16, 67):
        assert Mo.diamond_steps(r) == JMo.diamond_steps(r)


NAMES = {
    "codec.jpeg_encode_decode": _jpeg_encode_decode,
    "codec.jpeg_bits": _jpeg_bits,
    "codec.VideoCodecConfig,encode_chunk,decode_chunk": _video_codec,
    "codec.QUALITY_LADDER,ladder_for_bandwidth": _quality_ladder,
    "core.classify_frames": _classify_frames,
    "core.min_reward_fairness,jain_index": _fairness,
    "kernels.blockdct.blockdct_quantize": _blockdct_quantize,
    "kernels.flash_attention.flash_attention": _flash_attention,
    "kernels.qtransfer.qtransfer": _qtransfer,
    "kernels.roi_gather.roi_gather_ref": _roi_gather_ref,
    "codec.blockdct.blockify,unblockify,quantize,motion.diamond_steps":
        _codec_helpers,
}


@pytest.mark.parametrize("names", sorted(NAMES))
def test_public_names_match_the_reference(names):
    NAMES[names]()
