"""The port's kernel modules on the CPU: each plain PyTorch version against
the JAX package's kernel oracle (and the Pallas kernel in interpret mode
where its own tests run it so), plus the wrappers' routing and checks.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds them
against these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import blockdct as JB
from repro.codec import motion as JM
from repro.kernels.blockdct.ops import blockdct_quantize
from repro.kernels.blockdct.ref import blockdct_ref
from repro.kernels.motion_sad.ref import motion_sad_ref
from repro.kernels.qtransfer.ref import qtransfer_ref
from repro_torch.codec.blockdct import dct_matrix, quant_table
from repro_torch.kernels.blockdct import ops as dct_ops
from repro_torch.kernels.motion_sad.ops import motion_sad, motion_sad_plain
from repro_torch.kernels.qtransfer.ops import qtransfer, qtransfer_plain


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --------------------------------------------------------------- blockdct
@pytest.mark.parametrize("nb,quality", [(64, 50.0), (100, 20.0),
                                        (256, 80.0), (7, 95.0)])
def test_blockdct_plain_matches_ref(nb, quality):
    blocks = np.random.default_rng(4).uniform(-128, 127, (nb, 8, 8)) \
        .astype(np.float32)
    q, rec = dct_ops.forward_quant_plain(_t(blocks), dct_matrix(),
                                         quant_table(quality))
    qr, recr = (np.asarray(a) for a in blockdct_ref(jnp.asarray(blocks),
                                                     quality))
    # the two sum the 8x8 products in different orders, so round() may
    # land on either side of an exact .5 boundary: |dq| <= 1 and rare, as
    # in tests/test_kernels.py; rec is compared where q agrees
    dq = np.abs(q.numpy() - qr)
    assert dq.max() <= 1.0 and dq.mean() < 0.01
    agree = (dq == 0).all(axis=(1, 2))
    np.testing.assert_allclose(rec.numpy()[agree], recr[agree], atol=1e-3)
    # the Pallas kernel in interpret mode, as its own tests run it
    qk, reck = (np.asarray(a) for a in blockdct_quantize(
        jnp.asarray(blocks), quality, tile=min(nb, 32), interpret=True))
    dqk = np.abs(q.numpy() - qk)
    assert dqk.max() <= 1.0 and dqk.mean() < 0.01
    agree = (dqk == 0).all(axis=(1, 2))
    np.testing.assert_allclose(rec.numpy()[agree], reck[agree], atol=1e-3)


@pytest.mark.parametrize("quality", [30.0, 70.0])
def test_blockdct_inverse_plain_matches_codec(quality):
    q = np.random.default_rng(5).integers(-20, 21, (50, 8, 8)) \
        .astype(np.float32)
    qtab = np.asarray(JB.quant_table(quality))
    ref = np.asarray(JB.idct2(JB.dequantize(jnp.asarray(q), qtab)))
    rec = dct_ops.inverse_plain(_t(q), dct_matrix(), quant_table(quality))
    np.testing.assert_allclose(rec.numpy(), ref, atol=1e-3)


def test_blockdct_wrappers_route_cpu_to_plain_and_check_inputs():
    blocks = _t(np.random.default_rng(6).uniform(-128, 127, (9, 8, 8)))
    D, qt = dct_matrix(), quant_table(50.0)
    q, rec = dct_ops.forward_quant(blocks, D, qt)
    qp, recp = dct_ops.forward_quant_plain(blocks, D, qt)
    assert torch.equal(q, qp) and torch.equal(rec, recp)
    assert torch.equal(dct_ops.inverse(q, D, qt),
                       dct_ops.inverse_plain(q, D, qt))
    with pytest.raises(ValueError):
        dct_ops.forward_quant(blocks.reshape(9, 64), D, qt)
    with pytest.raises(ValueError):
        dct_ops.forward_quant(blocks.to("meta"), D, qt)


# -------------------------------------------------------------- motion_sad
def _frames(seed, H, W, integer):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H + 16, W + 16))
    ref = base[8:8 + H, 8:8 + W]
    cur = base[5:5 + H, 10:10 + W] + rng.normal(0, 3, (H, W))
    if integer:
        cur, ref = np.round(cur), np.round(ref)
    return cur.astype(np.float32), ref.astype(np.float32)


def _sad_f64(cur, ref, by, bx, dy, dx):
    H, W = ref.shape
    ys = np.clip(np.arange(by * 16, by * 16 + 16) + dy, 0, H - 1)
    xs = np.clip(np.arange(bx * 16, bx * 16 + 16) + dx, 0, W - 1)
    c = cur[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16].astype(np.float64)
    return np.abs(c - ref[np.ix_(ys, xs)].astype(np.float64)).sum()


@pytest.mark.parametrize("H,W,radius", [(64, 96, 8), (48, 80, 4)])
def test_motion_sad_plain_exact_on_integer_frames(H, W, radius):
    # integer-valued SADs are exact in f32 in any order: mv and sad match
    cur, ref = _frames(1, H, W, integer=True)
    mv, sad = motion_sad_plain(_t(cur), _t(ref), radius)
    mv_r, sad_r = motion_sad_ref(jnp.asarray(cur), jnp.asarray(ref),
                                 radius=radius)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_r))
    np.testing.assert_array_equal(sad.numpy(), np.asarray(sad_r))


def test_motion_sad_plain_on_float_frames_picks_equal_sads():
    # float SADs depend on the sum order: where the picks differ, the two
    # candidates' SADs must agree in f64 to 1e-5 relative
    cur, ref = _frames(2, 64, 96, integer=False)
    mv, sad = motion_sad_plain(_t(cur), _t(ref), 8)
    mv_r, sad_r = (np.asarray(a) for a in JM.block_sad_scan(
        jnp.asarray(cur), jnp.asarray(ref), 8))
    mv = mv.numpy()
    for by, bx in zip(*np.nonzero((mv != mv_r).any(-1))):
        a = _sad_f64(cur, ref, by, bx, *mv[by, bx])
        b = _sad_f64(cur, ref, by, bx, *mv_r[by, bx])
        assert abs(a - b) <= 1e-5 * max(a, b)
    same = (mv == mv_r).all(-1)
    np.testing.assert_allclose(sad.numpy()[same], sad_r[same], rtol=1e-5)


def test_motion_sad_wrapper_routes_cpu_and_checks_shapes():
    cur, ref = _frames(3, 32, 48, integer=True)
    mv, sad = motion_sad(_t(cur), _t(ref), 4)
    mv_p, sad_p = motion_sad_plain(_t(cur), _t(ref), 4)
    assert mv.dtype == torch.int32 and torch.equal(mv, mv_p)
    assert torch.equal(sad, sad_p)
    with pytest.raises(ValueError):
        motion_sad(_t(cur[:, :40]), _t(ref[:, :40]), 4)
    with pytest.raises(ValueError):
        motion_sad(_t(cur).to("meta"), _t(ref).to("meta"), 4)


# --------------------------------------------------------------- qtransfer
def _qt_inputs(seed, B, H, W, max_mv):
    rng = np.random.default_rng(seed)
    anchor = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    mv = rng.integers(-max_mv, max_mv + 1, (B, H // 16, W // 16, 2)) \
        .astype(np.int32)
    resid = rng.normal(0, 8, (B, H, W)).astype(np.float32)
    return anchor, mv, resid


@pytest.mark.parametrize("H,W,radius", [(64, 96, 8), (64, 96, 16),
                                        (48, 160, 8)])
def test_qtransfer_block_edge_matches_kernel_ref(H, W, radius):
    anchor, mv, resid = _qt_inputs(7, 2, H, W, radius + 4)
    out = qtransfer_plain(_t(anchor), torch.from_numpy(mv), _t(resid),
                          edge="block", radius=radius)
    for b in range(2):
        ref = qtransfer_ref(jnp.asarray(anchor[b]), jnp.asarray(mv[b]),
                            jnp.asarray(resid[b]), radius=radius)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("max_mv", [8, 16, 24, 120])
def test_qtransfer_pixel_edge_matches_warp_blocks(max_mv):
    # |mv| beyond the 16-px pad: warp_blocks' dynamic_slice counts a
    # negative block start from the end and then clamps it, and the pixel
    # mode must reproduce that exactly (120 > H + 32 wraps and clamps)
    anchor, mv, resid = _qt_inputs(8, 2, 64, 96, max_mv)
    gather = qtransfer_plain(_t(anchor), torch.from_numpy(mv), edge="pixel")
    added = qtransfer_plain(_t(anchor), torch.from_numpy(mv), _t(resid),
                            edge="pixel")
    for b in range(2):
        warped = np.asarray(JM.warp_blocks(jnp.asarray(anchor[b]),
                                           jnp.asarray(mv[b])))
        np.testing.assert_array_equal(gather[b].numpy(), warped)
        np.testing.assert_array_equal(
            added[b].numpy(), np.clip(warped + resid[b], 0.0, 255.0))


def test_qtransfer_edge_modes_differ_and_wrapper_checks():
    anchor, mv, resid = _qt_inputs(9, 1, 64, 96, 16)
    a, m, r = _t(anchor), torch.from_numpy(mv), _t(resid)
    pixel = qtransfer(a, m, r, edge="pixel")
    block = qtransfer(a, m, r, edge="block")
    assert torch.equal(pixel, qtransfer_plain(a, m, r, edge="pixel"))
    assert torch.equal(block, qtransfer_plain(a, m, r, edge="block"))
    # the two modes differ at the borders: they are not interchangeable
    assert float((pixel - block).abs().max()) > 50.0
    with pytest.raises(ValueError):
        qtransfer(a, m, r, edge="wrap")
    with pytest.raises(ValueError):
        qtransfer(a, m[:, :2], r)
    with pytest.raises(ValueError):
        qtransfer(a.to("meta"), m.to("meta"), r.to("meta"))


# ------------------------------------------------------------------- build
def _fake_nvcc(tmp_path, fail=False):
    """An ``nvcc`` stand-in that logs its arguments and writes its -o."""
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        + ("echo 'error: bad source'; exit 1\n" if fail else
           'while [ "$1" != "-o" ]; do shift; done; : > "$2"\n'))
    script.chmod(0o755)
    return script, log


def test_build_runs_one_nvcc_per_source_keyed_on_hash(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    assert set(build.build()) == set(build.SOURCES)
    lines = log.read_text().splitlines()
    assert len(lines) == len(build.SOURCES)
    for line in lines:
        assert "-gencode arch=compute_90a,code=sm_90a" in line
        assert "--use_fast_math" not in line
    for name in build.SOURCES:
        assert build._library_path(name).exists()
        assert build._library_path(name).parent == tmp_path / "kernels"
    assert build.build() == {}                  # nothing left to build
    assert len(log.read_text().splitlines()) == len(build.SOURCES)


def test_build_reports_a_failed_compile(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    nvcc, _ = _fake_nvcc(tmp_path, fail=True)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc failed on blockdct.cu"):
        build.build(("blockdct",))
    assert not build._library_path("blockdct").exists()
