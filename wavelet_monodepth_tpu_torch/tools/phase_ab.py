"""A/B timing of chip_smoke.py's phases between source trees of this
repo, on one CUDA card.

Each tree runs in its own process, from its own directory, with its own
chip_smoke.py and package, and nothing built (its `_build/` is removed
first). Untimed, as the tree's chip_smoke would have it before the
phase: its data workers where it has them (`start_data`, forked before
torch is imported, done before the clock starts), the device, the four
kernel sources (`phase_build`), what the phases need from earlier phases
(the 36-pair synthetic KITTI mount, a training checkpoint, the eval
mount, an NYU zip, the soak's checkpoint; PHASES below), and one tiny
torch.profiler trace (the profiler's one-time start-up, and the run's
first trace, which a tree that reads traces from the kineto results
checks against prof.events()). Then each phase in the order given,
timed on the host clock. The trees run in the order given, so `A B B A`
interleaves two of them; whole chip_smoke runs move by up to a minute
with the host, a phase alone in turns by seconds. Per run it prints the
tree's phase lines and, per phase, one JSON line {"phase": "phase_ab",
"tree": ..., "phase_name": ..., "seconds": ...}; the last line is a
summary: per tree and phase, its runs' seconds.

--phase names a phase, and may be given more than once (default: ddp,
phases 21-22 in one launch of the two rank processes); `--list` prints
the names. A phase that a tree's chip_smoke.py lacks fails that tree's
run.

`--table OUT.jsonl ...` reads whole chip_smoke runs' stdout instead and
prints, per run, each phase's seconds (from consecutive "t"s: a phase
ends at its last line) and the last phase line's "t", no card needed.

Usage, from the repo root on a machine with a card (any git-ignored
directory holds the other tree):
  mkdir -p _archive/parent && git archive HEAD~1 | tar x -C _archive/parent
  python3 wavelet_monodepth_tpu_torch/tools/phase_ab.py --phase nyu \\
      --phase nyu_train _archive/parent . . _archive/parent
  python3 wavelet_monodepth_tpu_torch/tools/phase_ab.py --table \\
      parent.jsonl final.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

# what a phase needs from earlier phases: the lines that make it, in the
# order of NEEDS, inside the temporary directory `tmp` (`made`: the data
# workers' result where the tree has them)
SETUP = {
    "kitti": ['root = os.path.join(tmp, "kitti")',
              "made(cs.write_kitti_mount, root, 36, cs.TRAIN_B)"],
    "ckpt": ["warp_launches, ckpt = cs.phase_train_slice(",
             '    dev, root, os.path.join(tmp, "log"))'],
    "eval": ["eval_root, folder18 = cs.phase_eval(dev, ckpt, tmp)"],
    "soak": ["cs.phase_soak(dev, root, tmp)"],
    "nyu_zip": ['nyu_zip = os.path.join(tmp, "nyu_data.zip")',
                'if hasattr(cs, "write_nyu_zip"):',
                "    made(cs.write_nyu_zip, nyu_zip)",
                "else:",
                "    from wavelet_monodepth_tpu_torch.data import synth",
                "    synth.fabricate_nyu(nyu_zip, "
                "n_train=cs.NYU_TRAIN_FRAMES)"],
    "models": ["enc, dec = cs.build_models(dev)"],
}
NEEDS = ("kitti", "ckpt", "eval", "soak", "nyu_zip", "models")

# phase name -> (what it needs, its call); `errs` takes any kernel's
# errors, `kernel_ms` any kernel's times
PHASES = {
    "kernel_vs_plain": ((), "cs.phase_kernel_vs_plain(dev, errs)"),
    "contracts": (("models",), "cs.phase_contracts(dev, enc, dec)"),
    "contracts_r50": ((), "cs.phase_contracts_r50(dev)"),
    "polyphase": (("models",), "cs.phase_polyphase(dev, enc, dec)"),
    "bf16_serving": (("models",), "cs.phase_bf16_serving(dev, enc, dec)"),
    "times": (("models",), "cs.phase_times(dev, enc, dec, kernel_ms)"),
    "bench": ((), "cs.phase_bench(dev)"),
    "train_slice": (("kitti",), 'cs.phase_train_slice(dev, root, '
                                'os.path.join(tmp, "log"))'),
    "train_contracts": (("kitti",), "cs.phase_train_contracts(dev, root)"),
    "eval": (("kitti", "ckpt"), "cs.phase_eval(dev, ckpt, tmp)"),
    "kitti_pose": (("kitti", "ckpt"),
                   "cs.phase_kitti_pose(dev, root, tmp, warp_launches)"),
    "nyu": ((), "cs.phase_nyu(dev, errs, tmp)"),
    "nyu_train": ((), "cs.phase_nyu_train(dev, tmp)"),
    "kitti_hr_train": (("kitti",),
                       "cs.phase_kitti_hr_train(dev, root, tmp, errs)"),
    "visuals": (("kitti", "nyu_zip"),
                "cs.phase_visuals(dev, root, tmp, nyu_zip)"),
    "soak": (("kitti",), "cs.phase_soak(dev, root, tmp)"),
    "self_golden": (("kitti", "ckpt", "eval", "soak"),
                    "cs.phase_self_golden(dev, eval_root, tmp)"),
    "soak_nyu": (("nyu_zip",), "cs.phase_soak_nyu(dev, tmp, nyu_zip)"),
    "sparsity": ((), "cs.phase_sparsity(dev, tmp)"),
    "native": (("kitti", "ckpt", "eval"),
               "cs.phase_native(dev, eval_root, folder18)"),
    "serving_tools": (("kitti", "ckpt", "eval"),
                      "cs.phase_serving_tools(dev, eval_root, folder18, "
                      "os.path.join(tmp, cs.EVAL_CONFIGS[1][0]), tmp)"),
    "ddp": (("kitti", "nyu_zip"), "cs.phase_ddp(dev, root, tmp, nyu_zip)"),
}

# chip_smoke's phases in the order it runs them, each by the "phase" of
# its first line (--table)
SECTIONS = (
    ("1 device", "device"), ("2 build", "build"),
    ("3 kernel vs plain", "kernel_vs_plain"), ("4 serving", "slice"),
    ("5 contracts", "contract_thresh_minus1"), ("5d polyphase", "polyphase"),
    ("5a bf16 serving", "bf16_serving"),
    ("5b block io vs plain", "block_io_vs_plain"),
    ("5c fused vs plain", "fused_vs_plain"), ("6 serving times", "time_conv"),
    ("6b bench", "bench"), ("7 warp vs plain", "warp_vs_plain"),
    ("8 training", "kitti_mount"), ("9 training contracts",
                                    "contract_on_vs_off"),
    ("10 training times", "time_train_step"), ("11 eval", "eval_mount"),
    ("14 kitti_pose", "kitti_pose"), ("12 nyu", "nyu_mount"),
    ("13 nyu_train", "nyu_train"), ("15 kitti_hr_train", "kitti_hr_train"),
    ("16 visuals", "visuals"), ("17 soak", "soak"),
    ("17b self_golden", "self_golden"), ("17c soak_nyu", "soak_nyu"),
    ("18 sparsity", "sparsity"), ("19 native", "native"),
    ("20 serving_tools", "serving_export"), ("21-22 ddp + spatial", "ddp"))


def phase_seconds(lines) -> dict:
    """{"phases": {section: seconds}, "last_t": the last phase line's "t"}
    of one chip_smoke run's stdout lines: a section runs from the end of
    the one before to its own last line (a section the run lacks is
    left out)."""
    firsts = [first for _, first in SECTIONS]
    label = {first: name for name, first in SECTIONS}
    at, current, ends, last = 0, None, {}, 0.0
    for line in lines:
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if not isinstance(obj, dict) or "t" not in obj:
            continue
        if obj.get("phase") in firsts[at:]:
            at = firsts.index(obj["phase"], at) + 1
            current = label[obj["phase"]]
        if current is not None:
            ends[current] = obj["t"]
        last = obj["t"]
    out, start = {}, 0.0
    for name, _ in SECTIONS:
        if name in ends:
            out[name] = ends[name] - start
            start = ends[name]
    return {"phases": out, "last_t": last}


# one run, in the tree's directory
RUN = """
import collections, json, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
made = getattr(cs, "made", lambda fn, *args: (fn(*args), None))
with tempfile.TemporaryDirectory(prefix="phase_ab_") as tmp:
    pool = cs.start_data(tmp) if hasattr(cs, "start_data") else None
    dev = cs.phase_device()
    import torch
    cs.phase_build()
    if pool is not None:
        cs.finish_data(pool)
    errs = collections.defaultdict(float)
    kernel_ms = collections.defaultdict(
        lambda: collections.defaultdict(float))
{setup}
    cs.trace_calls(lambda: torch.zeros(1, device=dev).add_(1), 1)
{timed}
"""

TIMED = """    t0 = time.perf_counter()
    {call}
    seconds = time.perf_counter() - t0
    print(json.dumps({{"phase": "phase_ab", "tree": os.getcwd(),
                      "phase_name": {name!r}, "seconds": seconds}}),
          flush=True)"""


def script(phases: list) -> str:
    """The program that sets up `phases` in a tree and times each."""
    needs = {need for phase in phases for need in PHASES[phase][0]}
    lines = [ln for need in NEEDS if need in needs for ln in SETUP[need]]
    setup = "\n".join("    " + ln for ln in lines) or "    pass"
    timed = "\n".join(TIMED.format(call=PHASES[phase][1], name=phase)
                      for phase in phases)
    return RUN.format(setup=setup, timed=timed)


def run_tree(tree: str, phases: list, timeout: float) -> dict:
    """{phase: its seconds} in `tree`, its output passed through."""
    shutil.rmtree(os.path.join(tree, "wavelet_monodepth_tpu_torch",
                               "_build"), ignore_errors=True)
    out = subprocess.run([sys.executable, "-c", script(phases)], cwd=tree,
                         stdout=subprocess.PIPE, text=True,
                         stdin=subprocess.DEVNULL, timeout=timeout)
    print(out.stdout, end="", flush=True)
    if out.returncode != 0:
        raise SystemExit(f"phase_ab: {tree} exited with {out.returncode}")
    seconds = {}
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and obj.get("phase") == "phase_ab":
            seconds[obj["phase_name"]] = obj["seconds"]
    return seconds


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    help="tree directories, in the order to run them")
    ap.add_argument("--phase", dest="phases", action="append",
                    choices=sorted(PHASES),
                    help="a chip_smoke phase to time, in the order given; "
                         "repeat for more (default: ddp)")
    ap.add_argument("--list", action="store_true",
                    help="print the phases and what each needs, and exit")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for one tree's run")
    ap.add_argument("--table", nargs="+", metavar="OUT_JSONL",
                    help="print each chip_smoke run's phase seconds and "
                         "exit")
    args = ap.parse_args(argv)
    args.phases = args.phases or ["ddp"]
    if not args.trees and not args.list and not args.table:
        ap.error("name at least one tree")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.table:
        for path in args.table:
            with open(path) as f:
                print(json.dumps({"run": path, **phase_seconds(f)}),
                      flush=True)
        return 0
    if args.list:
        for name, (needs, _) in sorted(PHASES.items()):
            print(f"{name}: needs {', '.join(needs) or 'nothing'}")
        return 0
    seconds = {}
    for tree in args.trees:
        path = os.path.abspath(tree)
        for phase, s in run_tree(path, args.phases, args.timeout).items():
            seconds.setdefault(path, {}).setdefault(phase, []).append(s)
    print(json.dumps({"phase_ab_summary": seconds,
                      "phase_names": args.phases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
