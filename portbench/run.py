#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once, from the root of a
checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations and metrics are those of BENCHMARK.json; the
last line of standard output is the run's result as one JSON object.
Needs a CUDA card; without one it exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
