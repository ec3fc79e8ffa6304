"""Small CPU twins of the benchmark's cells: the same files, drivers,
adapters and references, at sizes a CPU test run holds. The port's
kernel wrappers run their plain versions on CPU tensors."""

import pytest
import torch

from benchmark import run as bench_run

SMALL = {"kitti_r18_640x192": (64, 128), "nyu_densenet161_640x480": (64, 96)}


def small_cell(name: str, **params):
    """The cell `name` at a CPU size: frames of SMALL's size, 2 per batch,
    4 in the pool. A cell file that BENCHMARK.json does not list (a cell
    kept out of it, PERF.md's Open questions) is loaded with an entry of
    its own and no metrics but setup_s."""
    bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    if all(w["name"] != name for w in bench["workloads"]):
        spec = bench_run.load_json(bench_run.BENCH_DIR / "workloads"
                                   / f"{name}.json")
        bench["workloads"].append({"name": name, "config": spec["config"],
                                   "chips": 1})
    cell = bench_run.load_cell(name, bench)
    h, w = SMALL[cell.entry["config"]]
    cell.config = dict(cell.config, height=h, width=w)
    base = {"batch": 2, "pool": 4}
    if "sample" in cell.params:
        base.update(sample=2, warmup=1)
    cell.spec = dict(cell.spec, params=dict(cell.params, **base, **params))
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cpu():
    return torch.device("cpu")
