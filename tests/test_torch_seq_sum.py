"""The ``seq_sum`` kernel's launch plan and its plain version on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it bit
for bit against the plain version there).  Here :func:`plan` is checked
over the grids the paths make and grids past the staging buffer: every
(lane, row) is summed by exactly one block, a block's tiles keep the rows'
and the columns' order, and the layout fits the kernel's limits.  The
schedule is then replayed with numpy's sequential f32 adds, which must
give the reference's sums bit for bit; and the plain version is held bit
for bit against ``repro.codec.blockdct.seq_sum`` at the anchors' batched
grid and the ``(S, 1, T)`` grids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import blockdct as JB
from repro_torch.kernels.seq_sum import ops

f32 = np.float32

# (L, R, C): the LR codec's bits (9 streams x 30 frames of 44 x 80 8x8
# blocks; one stream), the mean-|x| features (16x16 tiles), the anchors'
# bits (90 x 160 blocks of an HD frame; 9 streams, one), the (S, 1, T)
# video and anchor bits, a vector, and the odd shapes chip_smoke.py checks
PATH_GRIDS = [(270, 44, 80), (30, 44, 80), (270, 22, 40), (540, 22, 40),
              (60, 22, 40), (270, 90, 160), (30, 90, 160), (540, 45, 80),
              (9, 1, 30), (1, 1, 30), (3, 1, 200), (5, 200, 1), (4, 7, 13)]
# past one block's tile: rows streamed in row tiles (many lanes, few
# lanes); rows wider than a buffer, in column tiles; the most rows; lanes
# of a few rows, several a block, at odd widths and past a warp
WIDE_GRIDS = [(132, 200, 160), (2, 2000, 160), (2, 1, 40000),
              (140, 3, 20000), (1, ops.MAX_ROWS, 80), (3, ops.MAX_ROWS, 3),
              (7, 13, 5), (300, 3, 7), (1000, 1, 2), (2, 300, 13)]
CASES = PATH_GRIDS + WIDE_GRIDS


def _id(shape):
    return "x".join(map(str, shape))


def _grid(shape, seed=0):
    """Values spread over 7 decades, where the order of the adds shows."""
    rng = np.random.default_rng([*shape, seed])
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-3, 4, shape)).astype(f32)


@pytest.mark.parametrize("shape", CASES, ids=_id)
def test_plan_covers_every_row_once_in_order(shape):
    L, R, C = shape
    p = ops.plan(L, R, C)
    work = ops.schedule(p, L, R, C)
    assert len(work) == p.grid(L) == -(-L // p.lanes_per_cta)
    # the kernel's limits
    assert p.threads % ops.WARP == 0 and p.threads <= ops.MAX_THREADS
    assert p.tile_rows <= p.threads and p.lanes_per_cta <= p.threads
    assert p.smem_bytes(R) <= ops.MAX_SMEM
    assert 4 * p.tile_rows * p.stride <= ops.STAGE_BYTES
    assert p.stride == -(-p.tile_cols // 4) * 4
    # a tile is one run of x: whole rows, or a part of one row
    assert p.tile_cols == C or (p.tile_cols % 4 == 0 and p.tile_rows == 1)
    covered = np.zeros(L * R, np.int64)
    slots = {}
    for w in work:
        assert w.lane0 == w.block * p.lanes_per_cta
        assert 1 <= w.n_lanes <= p.lanes_per_cta
        assert w.rows == range(w.lane0 * R, (w.lane0 + w.n_lanes) * R)
        assert p.buffers == 2 or len(w.tiles) <= 1
        # row tiles in order; each row tile's column tiles from 0 to C in
        # order, each a contiguous run
        row_next, col_next = w.rows.start, 0
        for (row0, n_rows), (col0, n_cols) in w.tiles:
            assert 1 <= n_rows <= p.tile_rows and 1 <= n_cols <= p.tile_cols
            assert col0 == col_next and row0 == row_next
            col_next = col0 + n_cols
            if col_next == C:
                covered[row0:row0 + n_rows] += 1
                row_next, col_next = row0 + n_rows, 0
        assert row_next == w.rows.stop and col_next == 0
        for g in w.rows:
            # the row's slot in its block's totals
            slot = (w.block, _slot(g - w.lane0 * R, R))
            assert slot not in slots
            slots[slot] = g
    assert (covered == 1).all()
    assert max(s for _, s in slots) < p.smem_bytes(R) // 4 - \
        p.buffers * p.tile_rows * p.stride
    # each block scans lane j's slots for rows 0 .. R - 1: the lane's rows
    # in order
    for (block, s), g in slots.items():
        j, r = divmod(s, ops.total_stride(R))
        assert r < R and g == (block * p.lanes_per_cta + j) * R + r


def _slot(i, R):
    """Row i of a block's lanes (lane j's row r at i = j * R + r): its
    slot in the block's totals."""
    j, r = divmod(i, R)
    return j * ops.total_stride(R) + r


def _replay(p, x):
    """The kernel's adds in numpy f32, as ``schedule`` orders them: each
    row tile's column tiles carry the rows' sums on, the sums go to the
    block's slots, and the block adds a lane's slots in order from +0.0.
    ``np.cumsum`` adds strictly left to right."""
    L, R, C = x.shape
    flat = x.reshape(L * R, C)
    slots, out = {}, np.full(L, np.nan, f32)
    work = ops.schedule(p, L, R, C)
    for w in work:
        acc = None
        for (row0, n_rows), (col0, n_cols) in w.tiles:
            if col0 == 0:
                acc = np.zeros(n_rows, f32)
            tile = flat[row0:row0 + n_rows, col0:col0 + n_cols]
            acc = np.cumsum(np.concatenate([acc[:, None], tile], 1), 1,
                            dtype=f32)[:, -1]
            if col0 + n_cols == C:
                for i in range(n_rows):
                    slots[w.block, _slot(row0 + i - w.lane0 * R, R)] = acc[i]
    for w in work:
        for j in range(w.n_lanes):
            t = [slots[w.block, _slot(j * R + r, R)] for r in range(R)]
            out[w.lane0 + j] = np.cumsum(np.array([0.0] + t, f32),
                                         dtype=f32)[-1]
    return out


@pytest.mark.parametrize("shape", [s for s in CASES
                                   if s[0] * s[1] * s[2] <= 4e6], ids=_id)
def test_plan_replayed_in_f32_is_the_reference_order(shape):
    L, R, C = shape
    x = _grid((L, R, C))
    got = _replay(ops.plan(L, R, C), x)
    np.testing.assert_array_equal(
        got, ops.seq_sum_plain(torch.from_numpy(x)).numpy())
    # zero padding, a column suffix and a suffix of rows, adds nothing
    pad_rows = 3 if R + 3 <= ops.MAX_ROWS else 0
    padded = np.pad(x, ((0, 0), (0, pad_rows), (0, 5)))
    np.testing.assert_array_equal(
        _replay(ops.plan(L, R + pad_rows, C + 5), padded), got)


@pytest.mark.parametrize("shape", [(270, 90, 160), (9, 1, 30), (1, 1, 30),
                                   (2, 1, 40000), (6, 13, 7)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_version_bit_for_bit_the_reference(shape):
    x = _grid(shape, seed=1)
    ref = np.asarray(jax.vmap(JB.seq_sum)(jnp.asarray(x)))
    got = ops.seq_sum(torch.from_numpy(x))
    assert got.shape == (shape[0],) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # a torch.sum in its own order differs somewhere at these spreads
    if shape[1] * shape[2] >= 30:
        assert not np.array_equal(x.sum(axis=(1, 2), dtype=f32), ref)


def test_planner_picks_the_layout_each_grid_needs():
    # the (S, 1, T) grid: all nine streams in one block
    p = ops.plan(9, 1, 30)
    assert (p.grid(9), p.lanes_per_cta, p.tile_rows) == (1, 9, 9)
    # a thread a row where a bulk copy brings the tile in; where C is no
    # multiple of 4, threads enough to issue 4-byte copies at about 8 each
    assert ops.plan(270, 90, 160).threads == 96
    assert ops.plan(270, 90, 161).threads == ops.MAX_THREADS
    # 30 HD lanes on 132 SMs: a lane fits one block's tile, one block each
    p = ops.plan(30, 90, 160)
    assert (p.lanes_per_cta, p.grid(30), p.buffers) == (1, 30, 1)
    # 270 lanes: two LR lanes a block, one HD lane; every SM busy
    assert ops.plan(270, 44, 80).lanes_per_cta == 2
    for shape in ((270, 44, 80), (270, 90, 160)):
        assert ops.plan(*shape).grid(shape[0]) >= ops.H100_SMS
    # fewer SMs: more lanes a block, as far as a tile holds them
    assert ops.plan(270, 44, 80, n_sms=66).lanes_per_cta == 4
    # past the staging buffer: row tiles through two buffers, whether
    # lanes are many or few
    for L, R in ((132, 200), (2, 2000)):
        p = ops.plan(L, R, 160)
        assert p.tile_rows < R and p.buffers == 2 and p.grid(L) == L
    # a row wider than a buffer: column tiles
    p = ops.plan(2, 1, 40000)
    assert p.tile_cols < 40000 and p.buffers == 2
    # the most rows the kernel took before its redesign still plan
    assert ops.MAX_ROWS == 48 * 1024 // 4
    assert ops.plan(1, ops.MAX_ROWS, 1000).smem_bytes(ops.MAX_ROWS) \
        <= ops.MAX_SMEM


@pytest.mark.parametrize("bad", [(0, 3, 5), (2, 0, 5), (2, 3, 0),
                                 (2, ops.MAX_ROWS + 1, 5)], ids=_id)
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        ops.plan(*bad)


@pytest.mark.parametrize("bad,err,match", [
    (torch.zeros(3, 5), ValueError, "x must be"),
    (torch.zeros(0, 3, 5), ValueError, "x must be"),
    (torch.zeros(2, 3, 5, dtype=torch.float64), TypeError, "dtype"),
    (torch.zeros(2, 3, 5, dtype=torch.bfloat16), TypeError, "dtype"),
    (torch.zeros(2, 3, 5, requires_grad=True), RuntimeError, "no backward"),
    (torch.zeros(2, 3, 5, device="meta"), ValueError, "cpu or cuda")],
    ids=["2d", "empty", "f64", "bf16", "grad", "meta"])
def test_wrapper_checks(bad, err, match):
    with pytest.raises(err, match=match):
        ops.seq_sum(bad)


def test_wrapper_without_grad_takes_the_plain_version():
    x = torch.randn(4, 3, 5, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(ops.seq_sum(x), ops.seq_sum_plain(x))
    y = x.detach().transpose(1, 2)      # not contiguous
    assert torch.equal(ops.seq_sum(y), ops.seq_sum_plain(y.contiguous()))
