"""The harness finds every cell, configuration, driver, generator and
metric by name, BENCHMARK.json keeps to the contract's shape, and the
command refuses to run without a card."""

import json
import re
import subprocess
import sys

import pytest

from benchmark import run as bench_run

BENCH = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_found_by_name(name):
    cell = bench_run.load_cell(name)
    assert cell.driver.run and cell.gen and cell.reference.specs()
    assert cell.adapter and cell.work
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names, (name, m["name"])
        assert hasattr(cell.readers[m["name"]], "read")
    assert set(cell.params["limits"])


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        layers.setdefault(m["layer"], m["layer"])
    for c in BENCH["configs"]:
        assert (bench_run.ROOT / c["file"]).is_file()
        assert json.loads((bench_run.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]


def test_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=bench_run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        bench_run.load_cell("no_such_cell")
