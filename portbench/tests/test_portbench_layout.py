"""The harness finds every cell, configuration, traffic mix, limit file
and metric reader by name, and BENCHMARK.json keeps the contract's
shapes: names, units, sources, and every cell reporting what it must."""
import sys
from pathlib import Path

# the harness and the port, after everything else on the path: these
# tests share their processes with the repository's own
for _p in (Path(__file__).resolve().parents[1],
           Path(__file__).resolve().parents[2] / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import ast  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402

import pytest  # noqa: E402

from harness import spec  # noqa: E402


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_found_by_name(name):
    cell = spec.find_cell(name)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["cameras"]["pattern"] and cell.config["streams"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="static9-paper"):
        spec.find_cell("no-such-cell")


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS \
        + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])


def test_every_metric_file_has_a_reader():
    metrics = {m["name"] for m in BENCH["per_layer"]}
    files = {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")}
    assert metrics <= files
    for name in metrics:
        tree = ast.parse((spec.BENCH_DIR / "metrics" / f"{name}.py")
                         .read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body)
