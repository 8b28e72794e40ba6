"""The blockdct kernel module's raster entries on the CPU: raster frames
in, quantised coefficients in block order and raster reconstructions out.

Their plain versions must equal the block-order plain versions between a
``blockify`` and an ``unblockify``, bit for bit, and agree with the JAX
package's oracle (``repro.kernels.blockdct.ref.blockdct_ref``) and codec
(``dct2``, ``quantize_with_table``, ``idct2``) under the kernel's stated
contract: the two sum the 8x8 products in different orders, so round()
may land on either side of an exact .5 boundary, |dq| <= 1 and rare
(mean |dq| < 0.01 over all coefficients), and rec is compared within
1e-3 on the tiles whose q agrees.  The codec's raster entries and the
block entries give the same results on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import blockdct as JB
from repro.kernels.blockdct.ref import blockdct_ref
from repro_torch.codec import blockdct as B
from repro_torch.kernels.blockdct import ops

SHAPES = [(8, 8), (8, 24), (64, 96), (352, 640)]
FRAMES = [1, 3]


def _frames(F, H, W, seed=0):
    return np.random.default_rng([F, H, W, seed]).uniform(
        -128, 127, (F, H, W)).astype(np.float32)


def _hold_q(q, qr, rec, recr):
    """q (..., 8, 8) against the reference's qr, rec against recr on the
    tiles whose q agrees."""
    dq = np.abs(q - qr)
    assert dq.max() <= 1.0 and dq.mean() < 0.01
    agree = (dq == 0).all(axis=(-2, -1))
    np.testing.assert_allclose(rec[agree], recr[agree], atol=1e-3)


@pytest.mark.parametrize("quality", [50.0, 70.0])
@pytest.mark.parametrize("H,W", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("F", FRAMES)
def test_raster_forward_equals_block_form_and_matches_reference(
        F, H, W, quality):
    frames = _frames(F, H, W)
    D, qt = B.dct_matrix(), B.quant_table(quality)
    q, rec = ops.forward_quant_raster(torch.from_numpy(frames), D, qt)
    assert q.shape == (F, (H // 8) * (W // 8), 8, 8)
    assert rec.shape == (F, H, W)
    blocks = ops.blockify(torch.from_numpy(frames)).reshape(-1, 8, 8)
    qb, recb = ops.forward_quant_plain(blocks, D, qt)
    assert torch.equal(q.reshape(-1, 8, 8), qb)
    assert torch.equal(rec, ops.unblockify(recb.reshape(F, -1, 8, 8), H, W))

    # the JAX oracle on the same tiles, in block order
    jq, jrec = (np.asarray(a) for a in blockdct_ref(
        jnp.asarray(blocks.numpy()), quality))
    _hold_q(q.reshape(-1, 8, 8).numpy(), jq,
            ops.blockify(rec).reshape(-1, 8, 8).numpy(), jrec)


@pytest.mark.parametrize("quality", [50.0, 70.0])
@pytest.mark.parametrize("H,W", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("F", FRAMES)
def test_raster_inverse_equals_block_form_and_matches_codec(F, H, W,
                                                            quality):
    rng = np.random.default_rng([F, H, W])
    q = rng.integers(-20, 21, (F, (H // 8) * (W // 8), 8, 8)) \
        .astype(np.float32)
    D, qt = B.dct_matrix(), B.quant_table(quality)
    rec = ops.inverse_raster(torch.from_numpy(q), D, qt, H, W)
    assert rec.shape == (F, H, W)
    recb = ops.inverse_plain(torch.from_numpy(q).reshape(-1, 8, 8), D, qt)
    assert torch.equal(rec, ops.unblockify(recb.reshape(q.shape), H, W))
    jqt = np.asarray(JB.quant_table(quality))
    jrec = np.asarray(JB.idct2(JB.dequantize(jnp.asarray(q.reshape(-1, 8, 8)),
                                             jqt)))
    np.testing.assert_allclose(ops.blockify(rec).reshape(-1, 8, 8).numpy(),
                               jrec, atol=1e-3)


@pytest.mark.parametrize("H,W", [(8, 24), (64, 96)], ids=lambda v: str(v))
def test_codec_raster_entries_match_codec_pieces(H, W):
    """The codec's raster entries against the reference codec's plain
    pieces (dct2 -> quantize_with_table; dequantize -> idct2), and equal
    to the block entries on the same tiles."""
    frames = _frames(2, H, W, seed=1)
    qt = B.quant_table(50.0)
    q, rec = B.dct_quantize_raster(torch.from_numpy(frames), qt)
    jblocks = jnp.concatenate([JB.blockify(jnp.asarray(f)) for f in frames])
    jq = np.asarray(JB.quantize_with_table(JB.dct2(jblocks),
                                           jnp.asarray(qt.numpy())))
    jrec = np.asarray(JB.idct2(JB.dequantize(
        jnp.asarray(q.reshape(-1, 8, 8).numpy()), qt.numpy())))
    _hold_q(q.reshape(-1, 8, 8).numpy(), jq,
            B.blockify(rec).reshape(-1, 8, 8).numpy(), jrec)
    qb, recb = B.dct_quantize(B.blockify(torch.from_numpy(frames)), qt)
    assert torch.equal(q, qb) and torch.equal(B.blockify(rec), recb)
    px = B.dequant_idct_raster(q, qt, H, W)
    assert torch.equal(px, rec)
    assert torch.equal(B.blockify(px), B.dequant_idct(q, qt))


def test_raster_wrappers_check_inputs():
    D, qt = B.dct_matrix(), B.quant_table(50.0)
    frames = torch.zeros((2, 16, 24))
    for bad in (frames[0], frames[:, :12], frames[:, :, :20], frames[:0]):
        with pytest.raises(ValueError, match="frames must be"):
            ops.forward_quant_raster(bad, D, qt)
    with pytest.raises(ValueError, match="dmat and qtab"):
        ops.forward_quant_raster(frames, D[:4], qt)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.forward_quant_raster(frames.to("meta"), D.to("meta"),
                                 qt.to("meta"))
    q = torch.zeros((2, 6, 8, 8))
    for args in ((q, 16, 16), (q, 16, 20), (q[:, :, :4], 16, 24),
                 (q[:0], 16, 24)):
        with pytest.raises(ValueError, match="q must be"):
            ops.inverse_raster(args[0], D, qt, *args[1:])
    assert ops.inverse_raster(q, D, qt, 16, 24).shape == (2, 16, 24)
