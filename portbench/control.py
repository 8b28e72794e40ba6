#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card:

    python3 portbench/control.py --workload <cell> --seeds <n,n,...>
        [--control-seeds <k>] [--seconds <s>]

For each seed, in one process: the cell's inputs, a short window of the
program at the cell's own load, and its sampled chunks compared with the
reference (the lower readings); for the first ``--control-seeds`` seeds
the control, the reference computed one step below the configuration's
precision (``reference/roundtrip.py``), compared with the reference on
the same chunks (the upper readings).  One JSON line a seed, then the
largest lower and the smallest upper reading of each number.  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check, cli, loop, program, spec  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool,
             device="cuda", shrink=None) -> dict:
    inputs = program.make_inputs(cell.config, cell.traffic, seed,
                                 torch.device(device), **(shrink or {}))
    prog = program.Program(cell.config, inputs,
                           device=None if device == "cuda" else device)
    lp = loop.Loop(prog)
    lp.run(0, count=2)
    run = lp.run(2, seconds=seconds, rng=np.random.default_rng(seed))
    lower, upper = [], []
    for c in run.kept:
        got = {k: v.to(device) for k, v in c.host.items()}
        ref = check.reference_of(prog, c.index)
        lower.append(check.compare(got, ref))
        if control:
            ctl = check.reference_of(prog, c.index, precision="control")
            upper.append(check.compare(ctl, ref))
    lp.release(run)
    out = {"seed": seed, "chunks": [c.index for c in run.kept],
           "lower": check.worst(lower)}
    if control:
        out["upper"] = check.worst(upper)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    from repro_torch.kernels import build
    build.build(cli.KERNELS)
    rows = []
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.seconds, k < args.control_seeds)
        r["seconds"] = time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": cell.name, "seeds": len(rows),
               "lower_max": {n: max(r["lower"][n] for r in rows)
                             for n in check.NUMBERS},
               "upper_min": {n: min(r["upper"][n] for r in rows
                                    if "upper" in r)
                             for n in check.NUMBERS
                             if any("upper" in r for r in rows)}}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
