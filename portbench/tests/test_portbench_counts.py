"""The counts of operations and bytes equal hand counts at small
shapes."""
import sys
from pathlib import Path

# the harness and the port, after everything else on the path: these
# tests share their processes with the repository's own
for _p in (Path(__file__).resolve().parents[1],
           Path(__file__).resolve().parents[2] / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import pytest  # noqa: E402

from harness import counts  # noqa: E402


DET = {"channels": [16, 32, 64], "stride": 8}


def cfg(search="exhaustive", dtype="float32", roi=None, anchor_search=False):
    return {"codec": {"search": search, "dtype": dtype, "search_radius": 8},
            "detector": DET, "roi": roi, "anchor_search": anchor_search}


def test_detector_operations_by_hand():
    # 16x16 in: 8x8x16, 4x4x32, 2x2x64 out, then the 5-channel head
    assert counts.conv_ops(DET, 16, 16) == (2 * 16 * 1 * 9 * 64
                                            + 2 * 32 * 16 * 9 * 16
                                            + 2 * 64 * 32 * 9 * 4
                                            + 2 * 5 * 64 * 4)


def test_static_chunk_by_hand():
    # one 32x32 stream at scale 1, T = 2: frame 0 type 1, frame 1 type 2
    w = counts.chunk_work(cfg(), [1.0], [(1, 1, 0)], 32, 32, 2)
    px, mbs = 32 * 32, 4
    assert w.kernels["motion_sad"] == [1 * mbs * 289 * 256 * 2,
                                       2 * px * 4 + mbs * 12]
    assert w.kernels["blockdct"] == [2 * px * 64 + px * 32 + px * 64,
                                     2 * px * 12 + px * 8 + px * 12]
    assert w.kernels["qtransfer"] == [px + px, px * 8 + px * 12]
    n_sum = 2 * 16 + 3 * 4 + 2 * 2
    assert w.kernels["seq_sum"] == [n_sum, n_sum * 4]
    assert w.kernels["roi_gather"] == [0.0, 0.0]
    assert w.step_ops == 2 * counts.conv_ops(DET, 32, 32) \
        + w.kernels["motion_sad"][0] + w.kernels["blockdct"][0]
    assert w.bound_s("motion_sad") == pytest.approx(
        mbs * 289 * 256 * 2 / counts.F32_FLOPS)


def test_adaptive_chunk_by_hand():
    # two 64x64 streams at scales 1/4 and 1/2 (16x16, 32x32), diamond bf16
    # search, anchor search, ROI gate of 32-px regions, 4 patches a frame
    roi = {"region_px": 32, "halo": 8, "capacity": 4}
    c = cfg("diamond", "bfloat16", roi, anchor_search=True)
    w = counts.chunk_work(c, [0.25, 0.5], [(2, 1, 1), (1, 0, 3)], 64, 64, 4)
    motion = 3 * (1 + 4) * 37 * 256 * 2.0
    assert w.kernels["motion_sad"][0] == motion
    assert w.kernels["motion_sad"][1] == 3 * (2 * 256 * 2 + 12) \
        + 3 * (2 * 1024 * 2 + 4 * 12)
    hd = 64 * 64
    assert w.kernels["blockdct"][1] == 4 * 256 * 12 + 1 * 256 * 8 \
        + 4 * 1024 * 12 + 3 * hd * 12 + 6 * 3 * hd * 8
    assert w.kernels["roi_gather"][1] == 4 * 4 * 48 * 48 * 8
    assert w.step_ops == 4 * 4 * counts.conv_ops(DET, 48, 48) + motion \
        + w.kernels["blockdct"][0]
    n_sum = (4 * 4 + 7 * 1 + 8) + (4 * 16 + 7 * 4 + 8) + 6 * 3 * 64 + 2 * 4
    assert w.kernels["seq_sum"][0] == n_sum
