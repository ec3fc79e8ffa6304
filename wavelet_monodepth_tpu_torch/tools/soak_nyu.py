"""NYU training soak: host memory and the loss over epochs of DenseNet161
training.

Counterpart of `tools_dev/soak_nyu_experiment.py`. It runs the port's NYU
training CLI (`python -m wavelet_monodepth_tpu_torch.tools.train_nyu`:
DenseNet161 + the wavelet decoder at 640x480, batch 8, bf16 mixed
precision, the uint8 feed, TensorBoard logging, per-epoch checkpoints)
once, as a subprocess, over an nyu_data.zip (fabricated with
`data/synth.fabricate_nyu` when --data_path does not exist: 480 frames,
so 5 epochs x 60 steps by default), and meanwhile samples the trainer's
Rss and Anonymous memory every --interval seconds (`tools/soak_kitti.py`'s
monitor). Afterwards it reads the console log and the samples and writes
one JSON to --out with the JAX harness's keys and its six checks,
computed as the harness computes them: completed, all_losses_finite,
loss_trending_down (the lower of the last two epoch means below
TREND_FACTOR, 0.9, times the first), final_checkpoint_exists,
tb_events_exist and rss_stable (the second half of the samples stays
below 1.25x the first half's peak). Beside them: the per-line step
time, the anonymous memory with its slope after the start-up's ramp, and
whether tensorboardX imports (without it the trainer writes no event
file, and tb_events_exist cannot pass).

`median_step_s_after_warmup` is the JAX harness's key as the harness
computes it: the median logged `Time` divided by 5. Each logged `Time`
covers one step (the trainer resets its clock after every step), so the
step itself is `median_step_s_per_line`.

The trainer's MALLOC_ARENA_MAX is the harness's: WMD_NYU_ARENA_MAX
from the environment, where it is set. There is no kill and no resume,
as in the JAX harness. It writes the
JSON to --out, and the trainer's checkpoints and console log under
--log_dir, nothing else. The trainer runs on --device (cuda, which
raises without a card, or cpu).

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.soak_nyu \\
      --data_path nyu_data.zip --out soak_nyu.json [--epochs 5] \\
      [--device cpu --encoder_type mobilenet_light --use_224 \\
      --batch_size 2]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
import zipfile

from .soak_kitti import memory_source, monitor, slope_after_warmup

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LINE_RE = re.compile(r"Epoch: \[(\d+)\]\[(\d+)/(\d+)\]\t"
                     r"Time ([0-9.]+)\t Loss ([0-9.naninf-]+)")
TREND_FACTOR = 0.9                    # the JAX harness's
ARENA_MAX = os.environ.get("WMD_NYU_ARENA_MAX", "")
ENCODER_NAMES = {"densenet": "DN161", "mobilenet": "MobileNetV2",
                 "mobilenet_light": "MobileNetV2-light"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NYU training soak")
    p.add_argument("--data_path", required=True,
                   help="nyu_data.zip; fabricated when it does not exist")
    p.add_argument("--n_train", type=int, default=480,
                   help="frames of a fabricated zip")
    p.add_argument("--out", required=True, help="the result JSON")
    p.add_argument("--log_dir", default=None,
                   help="the trainer's log_dir (default: soak_nyu_logs "
                        "beside --out)")
    p.add_argument("--model_name", default="soak_nyu")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--log_frequency", type=int, default=30)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--encoder_type", default="densenet")
    p.add_argument("--use_224", action="store_true")
    p.add_argument("--no-bfloat16", dest="bfloat16", action="store_false")
    p.add_argument("--interval", type=float, default=10.0,
                   help="seconds between memory samples")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.log_dir is None:
        args.log_dir = os.path.join(
            os.path.dirname(os.path.abspath(args.out)), "soak_nyu_logs")
    return args


def train_argv(args) -> list:
    return (["--data_path", args.data_path,
             "--batch_size", str(args.batch_size), "--use_wavelets",
             "--epochs", str(args.epochs),
             "--log_frequency", str(args.log_frequency),
             "--num_workers", str(args.num_workers),
             "--encoder_type", args.encoder_type,
             "--model_name", args.model_name, "--log_dir", args.log_dir,
             "--device", args.device]
            + (["--bfloat16"] if args.bfloat16 else [])
            + (["--use_224"] if args.use_224 else []))


def config_of(args) -> str:
    """The JAX harness's config string at its settings."""
    size = "224x224" if args.use_224 else "640x480"
    enc = ENCODER_NAMES.get(args.encoder_type, args.encoder_type)
    return (f"NYU {enc} {size} b{args.batch_size} "
            f"{'bf16-mp' if args.bfloat16 else 'f32'} wavelets uint8-feed")


def zip_rows(path: str) -> int:
    """Rows of the zip's data/nyu2_train.csv (the trainer's frames)."""
    with zipfile.ZipFile(path) as zf:
        text = zf.read("data/nyu2_train.csv").decode("utf-8")
    return sum(1 for r in text.split("\n") if r)


def parse_lines(text: str) -> list:
    return [dict(epoch=int(m.group(1)), batch=int(m.group(2)),
                 time_s=float(m.group(4)), loss=float(m.group(5)))
            for m in LINE_RE.finditer(text)]


def trending_down(epoch_mean: dict, factor: float) -> bool:
    """The JAX harness's loss_trending_down: three epochs or more, and the
    lower of the last two epoch means below `factor` x the first."""
    ems = list(epoch_mean.values())
    return len(ems) >= 3 and min(ems[-2:]) < factor * ems[0]


def analyse(log: str, samples: list, *, epochs: int, steps_per_epoch: int,
            rc: int, final_checkpoint: bool, tb_event_files: list,
            wall_s: float, config: str, trend_factor: float = TREND_FACTOR,
            arena_max=None, memory_source: str = "smaps_rollup",
            tensorboardx_available: bool = True) -> dict:
    """The JAX harness's summary and checks (`tools_dev/
    soak_nyu_experiment.py:107-156`) from the console log and the (t,
    rss_mb, anon_mb) samples, with the port's keys beside them."""
    steps = parse_lines(log)
    losses = [s["loss"] for s in steps]
    by_epoch = {}
    for s in steps:
        by_epoch.setdefault(s["epoch"], []).append(s["loss"])
    epoch_mean = {e: sum(v) / len(v) for e, v in sorted(by_epoch.items())}
    # the median logged step time after the first epoch (epoch 0 carries
    # the start-up), each line's own step
    late = sorted(s["time_s"] for s in steps
                  if s["epoch"] >= 1 and s["batch"] > 0)
    per_line = late[len(late) // 2] if late else None
    rss = [(t, r) for t, r, _ in samples]
    anon = [(t, a) for t, _, a in samples if a is not None]
    checks = {
        "completed": rc == 0,
        "all_losses_finite": bool(losses) and all(
            v == v and abs(v) < 1e9 for v in losses),
        "loss_trending_down": trending_down(epoch_mean, trend_factor),
        "final_checkpoint_exists": final_checkpoint,
        "tb_events_exist": bool(tb_event_files),
        "rss_stable": (len(rss) > 3 and
                       max(r for _, r in rss[len(rss) // 2:])
                       < 1.25 * max(r for _, r in rss[:len(rss) // 2])),
    }
    return {
        "config": config,
        "epochs": epochs,
        "malloc_arena_max": arena_max or None,
        "trend_factor": trend_factor,
        "rss_timeline": [(round(t, 1), r) for t, r in rss],
        "total_steps": epochs * steps_per_epoch,
        "wall_s": wall_s,
        "first_losses": losses[:3],
        "last_losses": losses[-3:],
        "epoch_mean_loss": epoch_mean,
        # the JAX harness's figure: one step's time / 5
        "median_step_s_after_warmup":
            per_line / 5 if per_line is not None else None,
        "median_step_s_per_line": per_line,
        "rss_mb_first": rss[0][1] if rss else None,
        "rss_mb_max": max((r for _, r in rss), default=None),
        "rss_mb_last": rss[-1][1] if rss else None,
        "steps_per_epoch": steps_per_epoch,
        "n_logged_lines": len(steps),
        "anon_timeline": [(round(t, 1), a) for t, a in anon],
        "anon_mb_first": anon[0][1] if anon else None,
        "anon_mb_max": max((a for _, a in anon), default=None),
        "anon_mb_last": anon[-1][1] if anon else None,
        "anon_mb_per_min_after_warmup": slope_after_warmup(samples),
        "memory_source": f"/proc/<pid>/{memory_source}",
        "tb_event_files": tb_event_files,
        "tensorboardx_available": tensorboardx_available,
        "checks": checks,
        "ok": all(checks.values()),
    }


def has_tensorboardx() -> bool:
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        return False
    return True


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..utils.device import resolve_device
    resolve_device(args.device)          # no card: raise before launching
    source = memory_source(os.getpid())
    run_dir = os.path.join(args.log_dir, args.model_name)
    os.makedirs(args.log_dir, exist_ok=True)
    console = os.path.join(args.log_dir, "train_console.log")
    if os.path.exists(run_dir):
        import shutil
        shutil.rmtree(run_dir)
    if os.path.exists(console):
        os.remove(console)
    if not os.path.exists(args.data_path):
        print(f"[soak-nyu] fabricating {args.n_train} frames", flush=True)
        from ..data.synth import fabricate_nyu
        fabricate_nyu(args.data_path, n_train=args.n_train)
    steps_per_epoch = zip_rows(args.data_path) // args.batch_size

    t0 = time.time()
    print(f"[soak-nyu] launching trainer ({args.epochs} epochs x "
          f"{steps_per_epoch} steps)", flush=True)
    env = dict(os.environ)
    if ARENA_MAX:
        env["MALLOC_ARENA_MAX"] = ARENA_MAX
    with open(console, "ab", buffering=0) as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "wavelet_monodepth_tpu_torch.tools.train_nyu"]
            + train_argv(args), cwd=REPO, stdout=logf,
            stderr=subprocess.STDOUT, env=env)
    samples, stop = [], threading.Event()
    threading.Thread(target=monitor, args=(proc.pid, samples, stop,
                                           args.interval, source),
                     daemon=True).start()
    rc = proc.wait()
    stop.set()
    wall = time.time() - t0
    print(f"[soak-nyu] exited rc={rc} after {wall:.1f}s", flush=True)

    with open(console, errors="replace") as f:
        log = f.read()
    summary = analyse(
        log, samples, epochs=args.epochs, steps_per_epoch=steps_per_epoch,
        rc=rc, final_checkpoint=os.path.isdir(os.path.join(
            run_dir, "models", f"weights_{args.epochs - 1}")),
        tb_event_files=sorted(
            os.path.join(m, f) for m in ("train", "val")
            if os.path.isdir(os.path.join(run_dir, m))
            for f in os.listdir(os.path.join(run_dir, m))
            if "tfevents" in f),
        wall_s=wall, config=config_of(args),
        arena_max=ARENA_MAX,
        memory_source=source,
        tensorboardx_available=has_tensorboardx())
    summary["device"] = args.device
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if not k.endswith("_timeline")}, indent=1),
          flush=True)
    print(f"[soak-nyu] {'PASS' if summary['ok'] else 'FAIL'} -> "
          f"{args.out}", flush=True)
    return summary


if __name__ == "__main__":
    main()
