"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> ... \
        [--seconds 2] [--fault NAME]

For each seed, in one process: the cell's set-up and a short window at its
own load, then the compared numbers of what the window served against the
float32 reference (the lower readings), and of the control, the reference
computed in TF32 (`reference.common.Precision("tf32")`) put in the
program's place, against the same float32 reference (the upper readings).
One JSON line per seed. Needs a CUDA device, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of the traffic driver's FAULTS in "
                    "the program (the upper readings of numbers the "
                    "control does not fail)")
    args = ap.parse_args(argv)
    bench_run.pin_caches()
    cell = bench_run.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        r = cell.driver.calibrate(cell, seed, args.seconds,
                                  torch.device("cuda", 0), args.fault)
        print(json.dumps({"cell": cell.name, "seed": seed,
                          "fault": args.fault, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
