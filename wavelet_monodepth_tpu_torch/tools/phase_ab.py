"""A/B timing of chip_smoke.py's phases 21-22 (two-rank data-parallel
training, then spatial inference in the same rank processes:
`chip_smoke.phase_ddp`) between source trees of this repo, on one CUDA
card.

Each tree runs in its own process, from its own directory, with its own
chip_smoke.py and package, and nothing built (its `_build/` is removed
first): the device, the kernels the rank jobs launch (K1/K4, K3, K5/K6),
the 36-pair synthetic KITTI mount, then `phase_ddp`, timed on the host
clock. The trees run in the order given, so `A B B A` interleaves two of
them; whole chip_smoke runs move by up to a minute with the host, a
phase alone in turns by seconds. Per run it prints the tree's phase
lines and one JSON line {"phase": "phase_ab", "tree": ...,
"phase_ddp_seconds": ...}; the last line is a summary: per tree, its
runs' seconds.

Usage, from the repo root on a machine with a card (any git-ignored
directory holds the other tree):
  mkdir -p _archive/parent && git archive HEAD~1 | tar x -C _archive/parent
  python3 wavelet_monodepth_tpu_torch/tools/phase_ab.py \\
      _archive/parent . . _archive/parent
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

# one run, in the tree's directory
RUN = """
import json, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
dev = cs.phase_device()
from wavelet_monodepth_tpu_torch.kernels import build
build.load_all(["tile_sparse_conv", "banded_warp", "blockio"])
with tempfile.TemporaryDirectory(prefix="phase_ab_") as tmp:
    root = os.path.join(tmp, "kitti")
    cs.write_kitti_mount(root, 36, cs.TRAIN_B)
    t0 = time.perf_counter()
    cs.phase_ddp(dev, root, tmp)
    seconds = time.perf_counter() - t0
print(json.dumps({"phase": "phase_ab", "tree": os.getcwd(),
                  "phase_ddp_seconds": seconds}), flush=True)
"""


def run_tree(tree: str, timeout: float) -> float:
    """phase_ddp's seconds in `tree`, its output passed through."""
    shutil.rmtree(os.path.join(tree, "wavelet_monodepth_tpu_torch",
                               "_build"), ignore_errors=True)
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                         stdout=subprocess.PIPE, text=True,
                         stdin=subprocess.DEVNULL, timeout=timeout)
    print(out.stdout, end="", flush=True)
    if out.returncode != 0:
        raise SystemExit(f"phase_ab: {tree} exited with {out.returncode}")
    last = json.loads(out.stdout.strip().splitlines()[-1])
    return last["phase_ddp_seconds"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+",
                    help="tree directories, in the order to run them")
    ap.add_argument("--timeout", type=float, default=400.0,
                    help="seconds for one tree's run")
    args = ap.parse_args(argv)
    seconds = {}
    for tree in args.trees:
        path = os.path.abspath(tree)
        seconds.setdefault(path, []).append(run_tree(path, args.timeout))
    print(json.dumps({"phase_ab_summary": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
