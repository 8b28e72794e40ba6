"""A tiny cell runs end to end on the CPU through the port's plain
paths, and a run with the timed path broken underneath comes out not
correct: the harness's look for a card skipped, everything else as in a
run."""
import sys
from pathlib import Path

# the harness and the port, after everything else on the path: these
# tests share their processes with the repository's own
for _p in (Path(__file__).resolve().parents[1],
           Path(__file__).resolve().parents[2] / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import re  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from harness import cli, program, spec  # noqa: E402


TINY = dict(n_streams=2, frame_hw=(80, 160), chunk_frames=4)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def run(name, traced=False, seed=2 ** 31 + 3, seconds=0.3):
    return cli.run_cell(spec.find_cell(name), seed, seconds, traced,
                        time.perf_counter(), device="cpu", shrink=TINY,
                        traced_chunks=1)


@pytest.mark.parametrize("name", ["static9-paper", "adaptive9-links"])
def test_tiny_cell_end_to_end(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    cell = spec.find_cell(name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    for k, v in r["metrics"].items():
        assert NAME.match(k) and UNIT.match(v["unit"]) and v["value"] >= 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(cell.limits) | {"precision_off"}


def test_tiny_traced_run_reads_its_host_metrics():
    # long enough that a chunk completes in the window on a loaded host
    r = run("static9-paper", traced=True, seconds=3.0)
    assert r["correct"]
    assert {"host_enqueue_ms", "round_trip_mfu_pct"} <= set(r["metrics"])
    assert 0 < r["metrics"]["round_trip_mfu_pct"]["value"] < 100
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def stale(submit):
    """A step that returns its state unchanged: each chunk gets the
    outputs of the chunk before it."""
    last = {}

    def broken(self, i):
        out = submit(self, i)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return broken


def half_batch(submit):
    """Half of the streams left out: the others' outputs stand in."""
    def broken(self, i):
        out = submit(self, i)
        return {k: v[:1].expand_as(v).clone() for k, v in out.items()}
    return broken


def altered(submit):
    """One answer altered where it is produced: one cell's score."""
    def broken(self, i):
        out = submit(self, i)
        out["scores"] = out["scores"].clone()
        out["scores"][-1, -1, 7] += 0.01
        return out
    return broken


def tf32_left_on(submit):
    """The convolutions switched to TF32, which the configuration does
    not state, after the entry returns."""
    def broken(self, i):
        out = submit(self, i)
        torch.backends.cudnn.allow_tf32 = True
        return out
    return broken


@pytest.mark.parametrize("fault", [stale, half_batch, altered, tf32_left_on],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(program.Program, "submit",
                        fault(program.Program.submit))
    was = torch.backends.cudnn.allow_tf32
    try:
        assert not run("static9-paper")["correct"]
    finally:
        torch.backends.cudnn.allow_tf32 = was
