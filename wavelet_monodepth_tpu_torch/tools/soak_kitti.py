"""KITTI training soak: host memory over epochs, a kill and a resume.

Counterpart of `tools_dev/soak_kitti_experiment.py`. It runs the port's
training CLI (`python -m wavelet_monodepth_tpu_torch.tools.train_kitti`:
stereo + depth hints, ResNet18 640x192, bf16 mixed precision, batch 12,
the uint8 feed, TensorBoard logging, per-epoch checkpoints, and the
from-scratch stabilisers --hint_disp_l1_weight and --disp_head_bias -4)
as a subprocess on a KITTI-layout mount, and meanwhile:

  * samples the trainer's Rss and Anonymous memory from
    /proc/<pid>/smaps_rollup (else /proc/<pid>/status's VmRSS and RssAnon,
    else /proc/<pid>/statm's resident and resident-minus-shared pages)
    every --interval seconds (anonymous memory leaves out the file-backed
    pages the kernel can reclaim);
  * sends SIGKILL once epoch --kill_after_epoch's checkpoint is complete
    (its adam.pth, written last, is there), then relaunches the trainer
    with --auto_resume;
  * reads the console log and the samples afterwards and writes one JSON
    to --out with the JAX harness's keys and checks: completed,
    resumed_from_killed_epoch, phase_b_logged, all_losses_finite,
    loss_trending_down, final_checkpoint_exists and anon_rss_stable
    (the second half of the resumed run's anonymous-memory samples stays
    below 1.25x the first half's peak). It adds the anonymous-memory
    slope over the second half of each phase's samples (after the
    start-up's ramp).

The JAX harness's --steps_per_call 4 (its `lax.scan` K-step program,
which the port does not port) is left out; every other training argument
is kept. It writes the JSON to --out and the trainer's checkpoints and
console log under --log_dir, nothing else. The trainer runs on --device
(cuda, which raises without a card, or cpu).

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.soak_kitti \\
      --data_path ROOT --split eigen --out soak.json [--num_epochs 6 \\
      --kill_after_epoch 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LINE_RE = re.compile(
    r"epoch\s+(\d+) \| batch\s+(\d+) \| forward: +([0-9.]+)s "
    r"\(examples/s: +([0-9.]+)\) \| dataloading: ([0-9.]+)s "
    r"\| loss: ([0-9.naninf-]+)")
RESUME_RE = re.compile(r"auto-resume: restoring (\S+), continuing "
                       r"at epoch (\d+)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="KITTI training soak")
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="eigen")
    p.add_argument("--out", required=True, help="the result JSON")
    p.add_argument("--log_dir", default=None,
                   help="the trainer's log_dir (default: soak_logs beside "
                        "--out)")
    p.add_argument("--model_name", default="soak")
    p.add_argument("--num_epochs", type=int, default=6)
    p.add_argument("--kill_after_epoch", type=int, default=3)
    p.add_argument("--interval", type=float, default=10.0,
                   help="seconds between memory samples")
    p.add_argument("--poll", type=float, default=5.0,
                   help="seconds between checks for the kill checkpoint")
    p.add_argument("--kill_delay", type=float, default=2.0,
                   help="seconds from the checkpoint to the kill")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--log_frequency", type=int, default=40)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--hint_disp_l1_weight", type=float, default=1.0)
    p.add_argument("--no-bfloat16", dest="bfloat16", action="store_false")
    p.add_argument("--arena_max", type=str, default="",
                   help="MALLOC_ARENA_MAX for the trainer (an A/B of glibc "
                        "arena growth)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.log_dir is None:
        args.log_dir = os.path.join(
            os.path.dirname(os.path.abspath(args.out)), "soak_logs")
    return args


def train_argv(args) -> list:
    return (["--data_path", args.data_path, "--split", args.split,
             "--use_stereo", "--frame_ids", "0",
             "--use_depth_hints", "--use_wavelets",
             "--height", str(args.height), "--width", str(args.width),
             "--batch_size", str(args.batch_size),
             "--num_epochs", str(args.num_epochs),
             # dense telemetry for the whole run, the resumed part included
             "--log_frequency", str(args.log_frequency), "--log_always",
             "--num_workers", str(args.num_workers),
             # the from-scratch stabilisers of the JAX harness (no ImageNet
             # weights offline)
             "--hint_disp_l1_weight", str(args.hint_disp_l1_weight),
             "--disp_head_bias", "-4.0",
             "--model_name", args.model_name, "--log_dir", args.log_dir,
             "--device", args.device]
            + (["--bfloat16"] if args.bfloat16 else []))


# where a process's resident and anonymous memory are read, in order:
# smaps_rollup's Rss / Anonymous, status's VmRSS / RssAnon, or statm's
# resident pages and resident minus shared (file-backed) pages, for
# kernels or container runtimes whose /proc lacks the first ones
MEMORY_SOURCES = (("smaps_rollup", "Rss:", "Anonymous:"),
                  ("status", "VmRSS:", "RssAnon:"),
                  ("statm", None, None))


def read_memory(pid: int, source: str = "smaps_rollup"):
    """(rss_mb, anon_mb) of a process from /proc/<pid>/<source>; either
    is None where the file lacks it."""
    _, rss_key, anon_key = next(s for s in MEMORY_SOURCES
                                if s[0] == source)
    with open(f"/proc/{pid}/{source}") as f:
        text = f.read()
    if rss_key is None:                     # statm: pages
        pages = [int(v) for v in text.split()]
        page_mb = os.sysconf("SC_PAGE_SIZE") / 2 ** 20
        return int(pages[1] * page_mb), int((pages[1] - pages[2]) * page_mb)
    rss = anon = None
    for ln in text.splitlines():
        if ln.startswith(rss_key):
            rss = int(ln.split()[1]) // 1024
        elif ln.startswith(anon_key):
            anon = int(ln.split()[1]) // 1024
    return rss, anon


def memory_source(pid: int) -> str:
    """The first of MEMORY_SOURCES this host gives for `pid`."""
    for name, _, _ in MEMORY_SOURCES:
        try:
            if None not in read_memory(pid, name):
                return name
        except (OSError, ValueError, IndexError):
            continue
    raise RuntimeError(f"no memory source in /proc/{pid}: tried "
                       f"{[s[0] for s in MEMORY_SOURCES]}")


def monitor(pid: int, out: list, stop: threading.Event, interval: float,
            source: str):
    """Append (t, rss_mb, anon_mb) samples until `stop` or the process
    ends."""
    while not stop.is_set():
        try:
            rss, anon = read_memory(pid, source)
        except (OSError, ValueError, IndexError):
            return
        if rss:                     # an exited process reads 0
            out.append((time.time(), rss, anon))
        stop.wait(interval)


def launch(args, extra: list, log_path: str):
    """The trainer as a subprocess (console to log_path) and its memory
    monitor: (process, samples, stop event)."""
    env = dict(os.environ)
    if args.arena_max:
        env["MALLOC_ARENA_MAX"] = args.arena_max
    with open(log_path, "ab", buffering=0) as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "wavelet_monodepth_tpu_torch.tools."
             "train_kitti"] + train_argv(args) + extra,
            cwd=REPO, stdout=logf, stderr=subprocess.STDOUT, env=env)
    samples, stop = [], threading.Event()
    threading.Thread(target=monitor, args=(proc.pid, samples, stop,
                                           args.interval, args.memory_source),
                     daemon=True).start()
    return proc, samples, stop


def checkpoint_complete(args, epoch: int) -> bool:
    """utils/checkpoint.py writes adam.pth last, by an atomic rename."""
    return os.path.exists(os.path.join(
        args.log_dir, args.model_name, "models", f"weights_{epoch}",
        "adam.pth"))


def steps_per_epoch(args) -> int:
    from ..data.splits import read_split
    return len(read_split(args.split, "train_files.txt",
                          args.data_path)) // args.batch_size


def parse_lines(text: str) -> list:
    return [dict(epoch=int(m.group(1)), batch=int(m.group(2)),
                 forward_s=float(m.group(3)), examples_s=float(m.group(4)),
                 dataload_s=float(m.group(5)), loss=float(m.group(6)))
            for m in LINE_RE.finditer(text)]


def slope_after_warmup(samples: list, warmup: float = 0.5):
    """Least-squares slope of anonymous MB per minute over the samples
    after the first `warmup` share of them; None with fewer than 3."""
    pts = [(t, a) for t, _, a in samples[int(len(samples) * warmup):]
           if a is not None]
    if len(pts) < 3:
        return None
    tm = sum(t for t, _ in pts) / len(pts)
    am = sum(a for _, a in pts) / len(pts)
    den = sum((t - tm) ** 2 for t, _ in pts)
    return (sum((t - tm) * (a - am) for t, a in pts) / den * 60.0
            if den else None)


def analyse(log: str, rss_a: list, rss_b: list, *, num_epochs: int,
            kill_after_epoch: int, steps_per_epoch: int, rc: int,
            final_checkpoint: bool, wall_s: float, phase_b_wall_s: float,
            tb_event_files: list, config: str, arena_max=None,
            memory_source: str = "smaps_rollup") -> dict:
    """The JAX harness's summary and checks (`tools_dev/
    soak_kitti_experiment.py:200-280`) from the console log and the
    memory samples of the two phases."""
    resume_m = RESUME_RE.search(log)
    phase_b_at = resume_m.start() if resume_m else len(log)
    steps_a_log = parse_lines(log[:phase_b_at])
    steps_b_log = parse_lines(log[phase_b_at:])
    steps = steps_a_log + steps_b_log
    losses = [s["loss"] for s in steps]
    by_epoch = {}
    for s in steps:
        by_epoch.setdefault(s["epoch"], []).append(s["loss"])
    epoch_mean = {e: sum(v) / len(v) for e, v in sorted(by_epoch.items())}
    ems = list(epoch_mean.values())
    resumed_epoch = int(resume_m.group(2)) if resume_m else None
    steps_b = ((num_epochs - resumed_epoch) * steps_per_epoch
               if resumed_epoch is not None else None)

    def rate_window(lo, hi):
        # the windowed wall rate of the console line; the first line of
        # each process measures start-up, so window over epochs [lo, hi)
        xs = [s for s in steps if lo <= s["epoch"] < hi]
        return (sum(x["examples_s"] for x in xs) / len(xs)) if xs else None

    # leak detection keys on anonymous memory: file-backed pages (the
    # libraries, the dataset's files) are reclaimable
    anon_b = [a for _, _, a in rss_b if a is not None]
    rss_all = rss_a + rss_b
    checks = {
        "completed": rc == 0,
        "resumed_from_killed_epoch": resumed_epoch == kill_after_epoch + 1,
        "phase_b_logged": len(steps_b_log) > 0,
        "all_losses_finite": len(losses) > 0 and all(
            v == v and abs(v) < 1e9 for v in losses),
        "loss_trending_down": len(ems) >= 4 and (
            sum(ems[-2:]) / 2 < 0.8 * sum(ems[:2]) / 2),
        "final_checkpoint_exists": final_checkpoint,
        "anon_rss_stable": (
            len(anon_b) > 3 and max(anon_b[len(anon_b) // 2:])
            < 1.25 * max(anon_b[:len(anon_b) // 2])),
    }
    return {
        "config": config,
        "steps_per_epoch": steps_per_epoch,
        "total_steps": num_epochs * steps_per_epoch,
        "wall_s": wall_s,
        "killed_after_epoch": kill_after_epoch,
        "resumed_at_epoch": resumed_epoch,
        "n_logged_lines": [len(steps_a_log), len(steps_b_log)],
        "first_losses": losses[:3],
        "last_losses": losses[-3:],
        "epoch_mean_loss": epoch_mean,
        "examples_s_early": rate_window(1, 4),
        "examples_s_late": rate_window(num_epochs - 2, num_epochs),
        "phase_b_wall_s": phase_b_wall_s,
        "phase_b_steps": steps_b,
        "phase_b_ms_per_step": (1e3 * phase_b_wall_s / steps_b
                                if steps_b else None),
        "rss_mb_first": rss_all[0][1] if rss_all else None,
        "rss_mb_max": max((r[1] for r in rss_all), default=None),
        "rss_mb_last": rss_all[-1][1] if rss_all else None,
        "anon_mb_max": max((r[2] for r in rss_all if r[2] is not None),
                           default=None),
        "anon_mb_last": rss_all[-1][2] if rss_all else None,
        "anon_mb_per_min_after_warmup": {"a": slope_after_warmup(rss_a),
                                         "b": slope_after_warmup(rss_b)},
        "malloc_arena_max": arena_max or None,
        "memory_source": f"/proc/<pid>/{memory_source}",
        "rss_timeline": [(round(t, 1), r, a) for t, r, a in rss_all],
        "tb_event_files": tb_event_files,
        "checks": checks,
        "ok": all(checks.values()),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..utils.device import resolve_device
    resolve_device(args.device)          # no card: raise before launching
    args.memory_source = memory_source(os.getpid())
    run_dir = os.path.join(args.log_dir, args.model_name)
    os.makedirs(args.log_dir, exist_ok=True)
    console = os.path.join(args.log_dir, "train_console.log")
    if os.path.exists(run_dir):
        import shutil
        shutil.rmtree(run_dir)
    if os.path.exists(console):
        os.remove(console)

    t0 = time.time()
    print(f"[soak] phase A: launching trainer ({args.num_epochs} epochs, "
          f"kill after epoch {args.kill_after_epoch})", flush=True)
    proc, rss_a, stop_a = launch(args, [], console)
    killed_at = None
    while proc.poll() is None:
        if checkpoint_complete(args, args.kill_after_epoch):
            time.sleep(args.kill_delay)
            print(f"[soak] weights_{args.kill_after_epoch} complete -> "
                  f"SIGKILL at t={time.time() - t0:.1f}s", flush=True)
            proc.send_signal(signal.SIGKILL)
            killed_at = time.time()
            break
        time.sleep(args.poll)
    proc.wait()
    stop_a.set()
    if killed_at is None:
        with open(console, errors="replace") as f:
            tail = f.read()[-3000:]
        raise RuntimeError("the trainer exited before the kill checkpoint "
                           f"(rc={proc.returncode}); the end of {console}:"
                           f"\n{tail}")

    print("[soak] phase B: relaunch with --auto_resume", flush=True)
    proc, rss_b, stop_b = launch(args, ["--auto_resume"], console)
    rc = proc.wait()
    stop_b.set()
    wall = time.time() - t0
    print(f"[soak] phase B exited rc={rc} after {wall:.1f}s", flush=True)

    with open(console, errors="replace") as f:
        log = f.read()
    summary = analyse(
        log, rss_a, rss_b, num_epochs=args.num_epochs,
        kill_after_epoch=args.kill_after_epoch,
        steps_per_epoch=steps_per_epoch(args), rc=rc,
        final_checkpoint=checkpoint_complete(args, args.num_epochs - 1),
        wall_s=wall, phase_b_wall_s=time.time() - killed_at,
        tb_event_files=sorted(
            os.path.join(m, f) for m in ("train", "val")
            if os.path.isdir(os.path.join(run_dir, m))
            for f in os.listdir(os.path.join(run_dir, m))
            if "tfevents" in f),
        config=(f"R18 {args.width}x{args.height} "
                f"b{args.batch_size} "
                f"{'bf16-mp' if args.bfloat16 else 'f32'} stereo+hints "
                f"uint8-feed log_always {args.device}"),
        arena_max=args.arena_max, memory_source=args.memory_source)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "rss_timeline"}, indent=1), flush=True)
    print(f"[soak] {'PASS' if summary['ok'] else 'FAIL'} -> {args.out}",
          flush=True)
    return summary


if __name__ == "__main__":
    main()
