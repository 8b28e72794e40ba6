"""The frozen traffic is deterministic in the seed, each camera's and
the uplink's seed offset from it, and today equal to the port's own
generator."""
import sys
from pathlib import Path

# the harness and the port, after everything else on the path: these
# tests share their processes with the repository's own
for _p in (Path(__file__).resolve().parents[1],
           Path(__file__).resolve().parents[2] / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import traffic as TR  # noqa: E402


TRAFFIC = json.loads((Path(__file__).resolve().parents[1] / "traffic"
                      / "paper9-shared-16mbps.json").read_text())
SPEC = TRAFFIC["cameras"]


def test_cameras_offset_from_the_seed():
    cams = TR.cameras(SPEC, 3, 64, 96, seed=2 ** 31 + 11)
    base = (2 ** 31 + 11) * TR.SEED_STRIDE
    assert [c.seed for c in cams] == [base + 100, base + 201, base + 102]
    assert cams[1].n_objects == 12 and cams[0].n_objects == 3
    assert cams[0].speed == 1.5 * 64 / 96


def test_the_pattern_is_the_ports_paper_mix():
    from repro_torch.sim.video_source import paper_stream_mix
    for cam, sc in zip(TR.cameras(SPEC, 9, 96, 160, seed=0),
                       paper_stream_mix(9, 96, 160)):
        assert (cam.name, cam.n_objects, cam.min_size, cam.max_size,
                cam.speed, cam.texture_contrast, cam.background_level,
                cam.seed) == (sc.name, sc.n_objects, sc.min_size,
                              sc.max_size, sc.speed, sc.texture_contrast,
                              sc.background_level, sc.seed)


def test_frames_deterministic_in_the_seed():
    def chunk(seed, t0=0):
        return TR.render_chunk(TR.cameras(SPEC, 3, 32, 48, seed), t0, 4,
                               "cpu")
    a, b, c = chunk(5), chunk(5), chunk(6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], chunk(5, t0=4)[0])
    assert a[1].shape == (3, 4, 12, 4) and not bool(a[2][0, :, 3:].any())


def test_links_deterministic_in_the_seed():
    spec = {"kind": "ar1", "mean_kbps": 16000.0, "std_log": 0.25,
            "ar": 0.9, "drop_prob": 0.02, "drop_factor": 0.3,
            "floor_kbps": 1000.0}
    a, b, c = TR.links(spec, 9, 9), TR.links(spec, 9, 9), TR.links(spec, 9, 10)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (TR.TRACE_STEPS, 9) and (a == a[:, :1]).all()
    assert a.min() >= 1000.0 / 9
    rungs = {TR.rung_for_link(x) for x in a[:, 0]}
    assert {0, 1, 2} <= rungs <= {0, 1, 2, 3}
    flat = TR.links(TRAFFIC["uplink"], 9, 1)
    assert (flat == 16000.0 / 9).all() and TR.rung_for_link(flat[0, 0]) == 1
    assert TR.rung_for_link(8000.0 / 9) == 0


def test_the_trace_is_the_ports_today():
    from repro_torch.sim.network import TraceConfig, generate_trace
    spec = {"kind": "ar1", **{k: v for k, v in vars(TraceConfig()).items()
                              if k != "seed"}}
    got = TR.links(spec, 1, 4)[:, 0]
    want = generate_trace(TraceConfig(seed=4 * TR.SEED_STRIDE + 300),
                          TR.TRACE_STEPS)
    assert np.allclose(got, want, rtol=1e-12)


def test_the_copy_renders_as_the_port_does_today():
    from repro_torch.sim.video_source import StreamConfig, generate_chunk
    cam = TR.cameras(SPEC, 2, 32, 48, seed=3)[1]
    frames, boxes, valid = TR.render_chunk([cam], 30, 5, "cpu")
    sc = StreamConfig(name=cam.name, height=32, width=48,
                      n_objects=cam.n_objects, min_size=cam.min_size,
                      max_size=cam.max_size, speed=cam.speed, seed=cam.seed)
    f, b, v = generate_chunk(sc, 30, 5, device="cpu")
    assert torch.equal(frames[0], f) and torch.equal(boxes[0], b)
