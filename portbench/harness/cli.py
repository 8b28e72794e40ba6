"""One run of one cell: set-up, warm-up, the measured window, with
``--trace 1`` a traced stretch, the comparison with the reference, and
the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Standard output ends with one JSON object (correct, attempted, failed,
metrics, device[, breakdown], checks); standard error ends with the
numbers compared, each beside its limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from harness import check, loop, program, readers, spec, trace
from harness import traffic as TR

WARM_CHUNKS = 3        # the first compiles and plans; the rest fill pools
TRACED_CHUNKS = 16
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KERNELS = ("motion_sad", "blockdct", "qtransfer", "seq_sum", "roi_gather")


def forbidden_modules() -> list:
    """Modules whose top-level name is JAX's, Flax's or the JAX package's,
    compared as whole names (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device=None, shrink: dict | None = None,
             traced_chunks: int = TRACED_CHUNKS, log=sys.stderr) -> dict:
    """Runs the cell once and returns the result object.  ``device``,
    ``shrink`` (n_streams, frame_hw, chunk_frames) and ``traced_chunks``
    serve the tests on the CPU; the benchmark's runs use none of them."""
    cfg = cell.config
    dev = torch.device(device or "cuda")
    phases = [("imports", time.perf_counter())]
    if dev.type == "cuda":
        from repro_torch.kernels import build
        torch.zeros(1, device=dev)
        phases.append(("context", time.perf_counter()))
        build.build(KERNELS)
        phases.append(("kernels", time.perf_counter()))
    inputs = program.make_inputs(cfg, cell.traffic, seed, dev,
                                 **(shrink or {}))
    prog = program.Program(cfg, inputs, device=device)
    phases.append(("inputs", time.perf_counter()))
    lp = loop.Loop(prog)
    lp.run(0, count=WARM_CHUNKS)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("setup phases: " + ", ".join(
        f"{name} {t - at:.3f} s" for (name, t), at in zip(
            phases, [t_start] + [t for _, t in phases])), file=log)
    window = lp.run(WARM_CHUNKS, seconds=seconds,
                    rng=np.random.default_rng(seed))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    off = check.precision_off(cfg)      # the switches the window ran with
    S, T, H, W = inputs.ring[0][0].shape
    done = window.done_by(window.t_end)
    lat = [(c.t_done - c.t_submit) * 1e3 for c in window.chunks]
    e2e = {"frames_per_s": (S * T * len(done) / seconds, "frames/s"),
           "chunk_p95_ms": (float(np.quantile(lat, 0.95)), "ms"),
           "peak_mem_gib": (peak / 2 ** 30, "GiB"),
           "setup_s": (setup_s, "s")}
    tr = None
    if traced:
        tr = trace.profile_chunks(lp, WARM_CHUNKS + len(window.chunks),
                                  traced_chunks)
    print(f"setup {setup_s:.3f} s; window {seconds} s: {len(window.chunks)} "
          f"chunks submitted, {len(done)} done in it; peak {peak} bytes",
          file=log)
    # the comparison, once the window is closed and its peak read
    t_ref = time.perf_counter()
    readings = []
    for c in window.kept:
        got = {k: v.to(dev) for k, v in c.host.items()}
        ref = check.reference_of(prog, c.index)
        readings.append(check.compare(got, ref))
        del got, ref
    lp.release(window)
    print(f"reference: {len(readings)} chunks in "
          f"{time.perf_counter() - t_ref:.3f} s", file=log)
    worst = check.worst(readings)
    correct, lines = check.judge(worst, cell.limits)
    lines.append(("precision_off", off, 0.0, off == 0.0))
    correct = correct and off == 0.0
    for k in check.NUMBERS:
        if k not in cell.limits:
            print(f"reading {k} {worst[k]!r} (not held)", file=log)
    for k, v, lim, held in lines:
        print(f"check {k} {v!r} limit {lim!r} {'ok' if held else 'FAIL'}",
              file=log)

    scales = (lambda i: [TR.LADDER[int(r)][1] for r in inputs.rungs[i]])
    ctx = readers.Context(cfg=cfg, shape=(S, T, H, W), scales=scales,
                          window=window, seconds=seconds, trace=tr)
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]][0]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": len(window.chunks),
              "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(0)
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_us * 1e-6
        result["device"]["window_s"] = tr.window_us * 1e-6
        result["breakdown"] = tr.breakdown
    result["checks"] = {k: {"value": float(v), "limit": lim}
                        for k, v, lim, _ in lines}
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    # one host thread for PyTorch's CPU operators: the process loads the
    # host with its dispatch alone, which keeps runs alike
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    print(f"card: {_card()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    m = result["metrics"]
    print("metrics: " + ", ".join(f"{k} {v['value']!r} {v['unit']}"
                                  for k, v in m.items()), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
