"""The motion search's plain versions across the shapes and radii the
card's sweep holds the kernel at (``chip_smoke.py``, ``[kernels]
motion_sad sweep``), on the CPU against the JAX package on the same numpy
frames, so that the kernel-vs-plain check on the card stands on plain
versions pinned to the reference.

Contracts: integer-valued frames exact (every f32 sum of integers below
2^24 is exact); float frames: an MV that differs from the reference's
must have the reference pick's SAD in f64 to within 1e-5 relative, and
SADs of equal picks agree within rtol 1e-5 (sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import motion as JM
from repro.kernels.motion_sad.ops import motion_sad as j_motion_sad_kernel
from repro_torch.codec import motion as M
from repro_torch.kernels.motion_sad.ops import MAX_RADIUS, motion_sad

SHAPES = [(16, 16), (16, 48), (48, 16), (32, 80), (176, 320)]
RADII = [0, 1, 2, 7, 9, 16]
BF16 = {None: None, "bf16": torch.bfloat16}
J_BF16 = {None: None, "bf16": jnp.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _frames(H, W, kind, seed=0):
    """(cur, ref) float32: a frame and its shifted, noisier successor
    (``float``, or rounded to 8-bit ``integer``), a ``constant`` pair, or
    a pair whose columns repeat every 4 px (``periodic``: dense exact
    ties), from a seed of their own."""
    rng = np.random.default_rng([H, W, len(kind), seed])
    if kind == "constant":
        a = np.full((H, W), 77.0, np.float32)
        return a, a.copy()
    if kind == "periodic":
        cols = np.tile(rng.integers(0, 256, (H + 3, 4)), (1, W // 4))
        return (cols[3:].astype(np.float32), cols[:H].astype(np.float32))
    base = rng.uniform(0, 255, (H + 32, W + 32))
    ref = base[16:16 + H, 16:16 + W]
    cur = base[13:13 + H, 18:18 + W] + rng.normal(0, 3, (H, W))
    if kind == "integer":
        cur, ref = np.clip(np.round(cur), 0, 255), np.round(ref)
    return cur.astype(np.float32), ref.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(H, W, kind, radius, search, dtype=None):
    """The JAX package's (mv, sad) as numpy: ``block_sad_scan`` for the
    exhaustive search, ``block_sad(search="diamond")`` for the diamond."""
    cur, ref = (jnp.asarray(a) for a in _frames(H, W, kind))
    if search == "exhaustive":
        assert dtype is None
        out = jax.jit(JM.block_sad_scan, static_argnums=2)(cur, ref, radius)
    else:
        out = JM.block_sad(cur, ref, radius, dtype=J_BF16[dtype],
                           search="diamond")
    return tuple(np.asarray(a) for a in out)


def _sad_f64(cur, ref, by, bx, dy, dx):
    H, W = ref.shape
    ys = np.clip(np.arange(by * 16, by * 16 + 16) + dy, 0, H - 1)
    xs = np.clip(np.arange(bx * 16, bx * 16 + 16) + dx, 0, W - 1)
    c = cur[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16].astype(np.float64)
    return np.abs(c - ref[np.ix_(ys, xs)].astype(np.float64)).sum()


def _hold(mv, sad, jmv, jsad, cur, ref, exact):
    mv, sad = mv.numpy(), sad.numpy()
    assert mv.dtype == np.int32 and mv.shape == jmv.shape
    assert sad.dtype == np.float32 and sad.shape == jsad.shape
    if exact:
        np.testing.assert_array_equal(mv, jmv)
        np.testing.assert_array_equal(sad, jsad)
        return
    for by, bx in zip(*np.nonzero((mv != jmv).any(-1))):
        a = _sad_f64(cur, ref, by, bx, *mv[by, bx])
        b = _sad_f64(cur, ref, by, bx, *jmv[by, bx])
        assert abs(a - b) <= 1e-5 * max(a, b)
    same = (mv == jmv).all(-1)
    np.testing.assert_allclose(sad[same], jsad[same], rtol=1e-5)


# ------------------------------------- the sweep's shapes and radii, exact
PLAIN = {
    # the port's scan oracle, the wrapper's plain exhaustive search (the
    # card's reference for the kernel) and its plain diamond search
    "block_sad_scan": lambda c, r, R: M.block_sad_scan(c, r, R),
    "motion_sad": lambda c, r, R: motion_sad(c, r, R),
    "diamond": lambda c, r, R: M.block_sad(c, r, R, search="diamond"),
}


# the diamond from radius 1
SWEEP = [pytest.param(plain, shape, radius, kind,
                      id=f"{plain}-{shape[0]}x{shape[1]}-R{radius}-{kind}")
         for plain in PLAIN for shape in SHAPES for radius in RADII
         for kind in ("integer", "float")
         if not (plain == "diamond" and radius == 0)]


@pytest.mark.parametrize("plain,shape,radius,kind", SWEEP)
def test_plain_searches_match_reference_across_shapes_and_radii(
        plain, shape, radius, kind):
    cur, ref = _frames(*shape, kind)
    search = "diamond" if plain == "diamond" else "exhaustive"
    jmv, jsad = _reference(*shape, kind, radius, search)
    mv, sad = PLAIN[plain](_t(cur), _t(ref), radius)
    _hold(mv, sad, jmv, jsad, cur, ref, exact=kind == "integer")


# ------------------------------------ constant and 4-px periodic frames
@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("search", ["exhaustive", "diamond"])
@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("shape", [(48, 16), (32, 80)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_constant_and_periodic_frames_exact(shape, radius, search, dtype):
    """A constant frame: every SAD 0, so the exhaustive search keeps its
    first candidate (-R, -R) and the diamond its start (0, 0).  Columns
    that repeat every 4 px: dense exact ties, which only the first-wins
    order over the same candidates resolves as the reference does."""
    for kind in ("constant", "periodic"):
        cur, ref = _frames(*shape, kind)
        mv, sad = motion_sad(_t(cur), _t(ref), radius, dtype=BF16[dtype],
                             search=search)
        if search == "exhaustive":
            jmv, jsad = _reference(*shape, kind, radius, search)
        else:
            jmv, jsad = _reference(*shape, kind, radius, search, dtype)
        _hold(mv, sad, jmv, jsad, cur, ref, exact=True)
        if kind == "constant":
            pick = -radius if search == "exhaustive" else 0
            assert (mv.numpy() == pick).all() and (sad.numpy() == 0).all()


# --------------------------------------------------- the batch dimension
@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("search", ["exhaustive", "diamond"])
def test_wrapper_batch_matches_pallas_kernel(search, dtype):
    """(T, H, W) frames through the wrapper on the CPU and through the
    reference's Pallas kernel in interpret mode (vmapped over T, as its
    own tests run it): integer frames, MVs and SADs exact, with a leading
    T on both outputs."""
    cur, ref = (np.stack(a) for a in zip(*(
        _frames(32, 48, "integer", seed) for seed in range(3))))
    mv, sad = motion_sad(_t(cur), _t(ref), 4, dtype=BF16[dtype],
                         search=search)
    assert mv.shape == (3, 2, 3, 2) and sad.shape == (3, 2, 3)
    jmv, jsad = j_motion_sad_kernel(jnp.asarray(cur), jnp.asarray(ref),
                                    radius=4, interpret=True,
                                    dtype=J_BF16[dtype], search=search)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jmv))
    np.testing.assert_array_equal(sad.numpy(), np.asarray(jsad))
    for t in range(3):
        mv1, sad1 = motion_sad(_t(cur[t]), _t(ref[t]), 4, dtype=BF16[dtype],
                               search=search)
        assert torch.equal(mv[t], mv1) and torch.equal(sad[t], sad1)


def test_wrapper_rejects_bad_shapes_and_radii():
    cur, ref = (_t(a) for a in _frames(32, 80, "integer"))
    with pytest.raises(ValueError, match="multiples of 16"):
        motion_sad(cur[None, None], ref[None, None], 4)
    with pytest.raises(ValueError, match="multiples of 16"):
        motion_sad(cur, ref[:16], 4)
    with pytest.raises(ValueError, match="multiples of 16"):
        motion_sad(cur[None], ref, 4)
    with pytest.raises(ValueError, match="multiples of 16"):
        motion_sad(cur[None, :0], ref[None, :0], 4)
    with pytest.raises(ValueError, match="multiples of 16"):
        motion_sad(cur[:, :40], ref[:, :40], 4)
    for search in ("exhaustive", "diamond"):
        with pytest.raises(ValueError, match="search radius"):
            motion_sad(cur, ref, -1, search=search)
    # the kernel's widest radius and one past it run on the CPU: the plain
    # versions take any radius, as the reference does (the CUDA branch
    # raises above MAX_RADIUS, which chip_smoke.py holds on the card)
    for radius in (MAX_RADIUS, MAX_RADIUS + 1):
        mv, _ = motion_sad(cur[:16, :16], ref[:16, :16], radius,
                           search="diamond")
        assert mv.shape == (1, 1, 2) and int(mv.abs().max()) <= radius


# ---------------------------- radii past the kernel's, on the CPU, exact
@pytest.mark.parametrize("search", ["exhaustive", "diamond"])
@pytest.mark.parametrize("radius", [MAX_RADIUS + 1, 100])
def test_cpu_search_takes_radii_past_the_kernel(radius, search):
    """The reference's ``block_sad`` takes any radius; so does the port's
    on CPU tensors.  Integer-valued 32x48 frames: MVs and SADs exact."""
    cur, ref = _frames(32, 48, "integer")
    jmv, jsad = JM.block_sad(jnp.asarray(cur), jnp.asarray(ref), radius,
                             search=search)
    mv, sad = M.block_sad(_t(cur), _t(ref), radius, search=search)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jmv))
    np.testing.assert_array_equal(sad.numpy(), np.asarray(jsad))
