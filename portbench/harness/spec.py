"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, the
configuration file it names, its traffic file, its limits and the readers
of its per-layer metrics.  Adding a cell, a configuration, a traffic mix
or a metric reader means adding files; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict           # the configuration as it is run
    traffic: dict
    limits: dict           # number compared -> its limit
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError names the known
    cells if there is none."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    return Cell(
        name=name, chips=w["chips"], config_name=w["config"],
        config=_json(root / entry["file"]),
        traffic=_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """``read(ctx)`` of ``metrics/<metric>.py``: the metric's value, or
    None when the run gives it nothing to read."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
