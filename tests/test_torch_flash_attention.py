"""The port's flash attention on the CPU (the wrapper takes its plain
version for CPU tensors) against the JAX package: its Pallas kernel in
interpret mode and its oracle ``attention_ref``, on the same numpy inputs.

Tolerance: the reference's own (``tests/test_kernels.py``), 0.03 absolute
for bf16 inputs and 0.02 for f32.  The plain version is ``attention_ref``
in f32 math; the Pallas kernel rounds q, k, v and p to bf16, which the
tolerance covers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)


def _inputs(seed, B, H, Hk, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Sk, Hk, D), (B, Sk, Hk, D)))
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    # bf16 inputs: both packages see the same rounded values
    j = [jnp.asarray(x, jdt) for x in (q, k, v)]
    t = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]
    return j, t


def _ref(jq, jk, jv, causal, window):
    tr = (0, 2, 1, 3)
    return np.asarray(attention_ref(jq.transpose(tr), jk.transpose(tr),
                                    jv.transpose(tr), causal=causal,
                                    window=window).transpose(tr), np.float32)


# the five cases of tests/test_kernels.py, its block-shape independence
# case at its two block shapes, then D=128 with GQA 4 and a window
CASES = [
    (2, 4, 2, 128, 128, 64, True, None, "f32", 64, 64),
    (1, 4, 4, 256, 256, 64, False, None, "f32", 64, 64),
    (1, 8, 2, 256, 256, 128, True, 96, "f32", 64, 64),
    (2, 2, 1, 64, 192, 64, True, None, "f32", 64, 64),   # cross Sq != Sk
    (1, 4, 2, 128, 128, 64, True, None, "bf16", 64, 64),
    (1, 4, 2, 128, 128, 64, True, None, "f32", 32, 64),
    (1, 4, 2, 128, 128, 64, True, None, "f32", 128, 128),
    (1, 8, 2, 128, 128, 128, True, 48, "bf16", 64, 64),
]


@pytest.mark.parametrize("B,H,Hk,Sq,Sk,D,causal,window,dtype,q_blk,k_blk",
                         CASES)
def test_flash_attention_matches_kernel_and_ref(B, H, Hk, Sq, Sk, D, causal,
                                                window, dtype, q_blk, k_blk):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, B, H, Hk, Sq, Sk, D, dtype)
    ours = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert ours.dtype == tq.dtype and ours.shape == tq.shape
    ours = ours.float().numpy()
    kernel = np.asarray(j_flash(jq, jk, jv, causal=causal, window=window,
                                q_blk=q_blk, k_blk=k_blk, interpret=True),
                        np.float32)
    tol = 0.03 if dtype == "bf16" else 0.02
    np.testing.assert_allclose(ours, kernel, atol=tol, rtol=0)
    np.testing.assert_allclose(ours, _ref(jq, jk, jv, causal, window),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("Sq,Sk,window", [(100, 100, None), (100, 100, 40),
                                          (50, 150, None)])
def test_flash_attention_ragged_matches_ref(Sq, Sk, window):
    """Lengths that are not a multiple of any tile.  Held against
    ``attention_ref`` only: the reference's Pallas kernel in interpret
    mode returns NaN here (its padded K/V blocks hold NaN, and p = 0 does
    not cancel 0 * NaN in the P V product; ROADMAP.md queue 3)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 1, 4, 2, Sq, Sk, 64, "f32")
    ours = flash_attention(tq, tk, tv, causal=True, window=window).numpy()
    np.testing.assert_allclose(ours, _ref(jq, jk, jv, True, window),
                               atol=1e-5, rtol=0)


def test_flash_attention_cpu_takes_the_plain_version_and_checks_shapes():
    _, (tq, tk, tv) = _inputs(2, 1, 4, 2, 32, 32, 64, "bf16")
    assert torch.equal(flash_attention(tq, tk, tv, window=8),
                       flash_attention_plain(tq, tk, tv, window=8))
    with pytest.raises(ValueError):        # 4 heads over 3 kv heads
        flash_attention(tq, tk[:, :, :1].expand(1, 32, 3, 64), tv)
    with pytest.raises(ValueError):        # k and v differ
        flash_attention(tq, tk, tv[:, :16])
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, window=0)


# Lengths and windows at the card kernel's tile edges (its bf16 design
# takes 128 q rows a block, 64 a consumer warpgroup, 128 keys a K/V tile).
# chip_smoke.py holds the kernel against the plain version at these
# shapes, so the plain version is held here against ``attention_ref`` on
# the same numpy inputs: 1e-5 absolute in f32 (both take f32 math); in
# bf16 the two f32 results round to bf16 apart by at most one bf16 step,
# 2^-7 of |value|.
EDGE_LENGTHS = (1, 127, 128, 129, 255, 257)


def _hold_plain(B, H, Hk, Sq, Sk, D, causal, window, dtype, seed=3):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed, B, H, Hk, Sq, Sk, D, dtype)
    ours = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert ours.dtype == tq.dtype and ours.shape == tq.shape
    ref = _ref(jq, jk, jv, causal, window)
    if dtype == "f32":
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(ours.float().numpy(), ref, atol=1e-6,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
@pytest.mark.parametrize("D", (64, 128))
@pytest.mark.parametrize("S", EDGE_LENGTHS)
def test_flash_attention_plain_at_tile_edge_lengths(S, D, dtype):
    _hold_plain(1, 4, 1, S, S, D, True, None, dtype)


@pytest.mark.parametrize("D", (64, 128))
@pytest.mark.parametrize("window", (127, 128, 129))
def test_flash_attention_plain_at_tile_edge_windows(window, D):
    _hold_plain(1, 4, 2, 259, 259, D, True, window, "f32")


@pytest.mark.parametrize("D", (64, 128))
@pytest.mark.parametrize("window", (127, 128, 129))
def test_flash_attention_plain_at_tile_edge_windows_bf16(window, D):
    _hold_plain(1, 4, 2, 259, 259, D, True, window, "bf16")


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (129, 300, True, None), (300, 129, True, None), (1, 257, True, None),
    (257, 257, False, 128), (129, 129, False, None)])
def test_flash_attention_plain_cross_and_non_causal_edges(Sq, Sk, causal,
                                                          window):
    _hold_plain(1, 4, 2, Sq, Sk, 64, causal, window, "f32")


@pytest.mark.parametrize("D", (64, 128))
@pytest.mark.parametrize("Hk", (16, 4, 1))
def test_flash_attention_plain_gqa_ratios(Hk, D):
    _hold_plain(1, 16, Hk, 129, 129, D, True, None, "f32")


def test_flash_attention_plain_three_requests():
    _hold_plain(3, 4, 2, 257, 257, 128, True, 200, "f32")
