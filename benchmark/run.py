"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name: `benchmark/workloads/<cell>.json` names its
configuration (`benchmark/configs/<config>.json`), its traffic driver
(`benchmark/traffic/<driver>.py`) and the driver's parameters; the
configuration's adapter, plain reference and work count are the modules
of its name under `adapters/`, `reference/` and `work/`; the metrics the
cell reports are BENCHMARK.json's, a per-layer metric read by
`benchmark/metrics/<metric>.py`. The run needs a CUDA device (as many as
the cell asks for) and never falls back to the CPU. It keeps the build
and kernel caches inside the checkout, checks that what the timed path
served is correct against the plain reference, and prints the compared
numbers beside their limits as the last lines on standard error; the
last line on standard output is one JSON object.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse                                           # noqa: E402
import importlib                                          # noqa: E402
import importlib.util                                     # noqa: E402
import json                                               # noqa: E402
import os                                                 # noqa: E402
import subprocess                                         # noqa: E402
import sys                                                # noqa: E402
from dataclasses import dataclass, field                  # noqa: E402
from pathlib import Path                                  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "wavelet_monodepth_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc; the module's import
    time where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _STARTED


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_file_module(path: Path, name: str):
    """A module from a file whose name may hold dots (a metric's)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


@dataclass
class Cell:
    """What a run of one cell needs, all found by name."""
    name: str
    entry: dict             # BENCHMARK.json's workload entry
    spec: dict              # benchmark/workloads/<name>.json
    config: dict            # benchmark/configs/<config>.json
    end_to_end: list        # BENCHMARK.json's metrics this cell reports
    per_layer: list
    adapter: object = None
    reference: object = None
    work: object = None
    driver: object = None
    gen: object = None
    readers: dict = field(default_factory=dict)

    @property
    def params(self) -> dict:
        return self.spec["params"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    config = load_json(ROOT / conf_entry["file"])
    if spec["config"] != entry["config"]:
        raise SystemExit(f"{name}: the cell's file names configuration "
                         f"{spec['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    cfg = entry["config"]
    cell = Cell(name, entry, spec, config,
                [m for m in bench["end_to_end"] if reports(m, name)],
                [m for m in bench["per_layer"] if reports(m, name)])
    cell.adapter = importlib.import_module(f"benchmark.adapters.{cfg}")
    cell.reference = importlib.import_module(f"benchmark.reference.{cfg}")
    cell.work = importlib.import_module(f"benchmark.work.{cfg}")
    cell.driver = importlib.import_module(
        f"benchmark.traffic.{spec['driver']}")
    cell.gen = importlib.import_module(f"benchmark.gen.{spec['gen']}")
    for m in cell.per_layer:
        cell.readers[m["name"]] = load_file_module(
            BENCH_DIR / "metrics" / f"{m['name']}.py",
            "benchmark_metric_" + m["name"].replace(".", "_"))
    return cell


def device_info(torch, chips: int) -> dict:
    dev = torch.device("cuda", 0)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def result_line(cell: Cell, res: dict, trace: bool, device: dict) -> dict:
    """The contract's JSON object; `checks` comes last."""
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        v = res["metrics"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if trace and res.get("breakdown") is not None:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    cell = load_cell(args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = device_info(torch, chips)
    print(json.dumps({"cell": cell.name, "device": device["kind"],
                      "devices": torch.cuda.device_count(),
                      "power": power_limit(), "seed": args.seed,
                      "seconds": args.seconds, "trace": args.trace,
                      "torch": torch.__version__}), file=sys.stderr,
          flush=True)
    res = cell.driver.run(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace),
                          device=torch.device("cuda", 0),
                          started=process_age_s)
    device["memory_peak_bytes"] = res["memory_peak_bytes"]
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may load neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 4
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result_line(cell, res, bool(args.trace), device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
