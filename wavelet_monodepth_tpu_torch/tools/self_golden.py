"""Self-golden check: close the train -> eval loop on a trained checkpoint.

Counterpart of `tools_dev/self_golden_experiment.py`. It takes a
checkpoint of the port's KITTI trainer (the newest
`<log_dir>/<model_name>/models/weights_N`, as `tools/soak_kitti.py`
leaves them, or --load_weights_folder) and a KITTI-layout eigen mount
with ground truth (a real one, or `data/synth.py`'s), and runs three legs
that need no external data:

  A. the published eval protocol dense: `tools/evaluate_depth.main` with
     --eval_stereo --use_wavelets --post_process on the eigen split;
  B. the same protocol sparse (--use_sparse --threshold t) for each of
     THRESHOLDS, each row with its mean density; the operating point is
     the row whose density lies nearest TARGET_DENSITY (a row without
     a density counts as dense, 1.0), and the check is the relative
     abs_rel gap between it and the dense row;
  C. an oracle for the numerics: the checkpoint loaded as the eval loads
     it, once on --device and once on the CPU in float32, forwarded on the
     split's first test frame as the eval decodes and resizes it, and the
     disparities compared scale by scale. The JAX harness cross-forwards
     the reference repo's own decoder here; that code is not part of this
     repo, so the port's stand-in is its CPU forward, which the port's
     tests hold to the JAX package's forward of the same weights. On
     --device cpu the two forwards are one computation and the gap is 0.

The summary carries the JAX harness's keys and its five checks, computed
as it computes them (`tools_dev/self_golden_experiment.py:217-248`):
dense_metrics_finite, dense_learned (abs_rel < 0.25), sparse_near_10pct_
exists (the operating point within 0.08 of the target), sparse_absrel_
delta_le_1p5pct and oracle_disp_close (every scale within 1e-3), and
"ok" when all hold. It writes the summary to --out and nothing else, and
runs on --device (cuda, which raises without a card, or cpu). Legs A
and B load the checkpoint checked, whatever WMD_TORCH_MODEL_PATH says.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.self_golden \\
      --data_path ROOT --log_dir LOGS [--model_name soak] --out X.json \\
      [--device cpu]
  python -m wavelet_monodepth_tpu_torch.tools.self_golden \\
      --data_path ROOT --load_weights_folder CKPT --out X.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

# the JAX harness's ladder and model (`tools_dev/self_golden_experiment.py:
# 48-55`) and its checks (`:226-237`)
THRESHOLDS = (0.02, 0.05, 0.1)
TARGET_DENSITY = 0.10
NUM_LAYERS = 18
LEARNED_ABS_REL = 0.25
NEAR_TARGET = 0.08
MAX_REL_DELTA = 0.015
ORACLE_TOL = 1e-3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="self-golden train -> eval "
                                            "check of a KITTI checkpoint")
    p.add_argument("--data_path", required=True,
                   help="a KITTI-layout mount with splits/eigen and its "
                        "gt_depths.npz")
    p.add_argument("--out", required=True, help="the summary JSON")
    p.add_argument("--log_dir", default=None,
                   help="the trainer's log_dir: the newest "
                        "<log_dir>/<model_name>/models/weights_N is checked")
    p.add_argument("--model_name", default="soak")
    p.add_argument("--load_weights_folder", default=None,
                   help="a checkpoint folder (encoder.pth, depth.pth), in "
                        "place of --log_dir")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if (args.log_dir is None) == (args.load_weights_folder is None):
        p.error("pass one of --log_dir and --load_weights_folder")
    return args


def newest_checkpoint(log_dir: str, model_name: str) -> str:
    """The weights_N folder with the largest N under
    <log_dir>/<model_name>/models."""
    folders = [f for f in glob.glob(os.path.join(
        log_dir, model_name, "models", "weights_*")) if os.path.isdir(f)]
    if not folders:
        raise FileNotFoundError(
            f"no weights_N folder under {log_dir}/{model_name}/models")
    return max(folders, key=lambda p: int(p.rsplit("_", 1)[1]))


def eval_argv(args, ckpt: str, device) -> list:
    """The eval flags of the JAX harness (its EVAL_BASE) for `ckpt`."""
    return ["--data_path", args.data_path, "--eval_split", "eigen",
            "--eval_stereo", "--use_wavelets", "--post_process",
            "--height", str(args.height), "--width", str(args.width),
            "--num_layers", str(NUM_LAYERS),
            "--batch_size", str(args.batch_size),
            "--load_weights_folder", ckpt, "--device", str(device)]


def first_test_frame(opts) -> np.ndarray:
    """The eval split's first test frame as the eval feeds it: decoded and
    resized by the eval dataset, (1, H, W, 3) uint8."""
    from ..data.splits import readlines, resolve_split_dir
    from . import evaluate_depth as ed
    files = readlines(os.path.join(resolve_split_dir(
        opts.eval_split, opts.data_path), "test_files.txt"))
    frame = ed.eval_dataset(opts, files[:1])[0][("color_u8", "0", 0)]
    return np.array(frame[None])            # a writable copy


def oracle_disps(opts, device, image: np.ndarray) -> dict:
    """{scale: (1, h, w, 1) float32 disparity} of the dense forward of
    the checkpoint, loaded as the eval loads it, on `device`."""
    import torch
    from . import evaluate_depth as ed
    forward = ed.load_forward(opts, device)
    out = forward(torch.from_numpy(image).to(device))
    return {s: out[("disp", s)].float().cpu().numpy() for s in range(4)}


def torch_oracle(opts, device) -> dict:
    """Leg C: disp{s}_maxerr between the forward on `device` and on the
    CPU, and the mean scale-0 disparity on `device`."""
    image = first_test_frame(opts)
    ours = oracle_disps(opts, device, image)
    ref = ours if str(device) == "cpu" else oracle_disps(opts, "cpu", image)
    errs = {f"disp{s}_maxerr": float(np.max(np.abs(ours[s] - ref[s])))
            for s in range(4)}
    errs["pred_disp0_mean"] = float(np.mean(ours[0]))
    return errs


def decide(dense: dict, sparse_rows: list, oracle: dict,
           target_density: float = TARGET_DENSITY) -> dict:
    """The operating point, the relative abs_rel gap and the checks, as
    the JAX harness computes them from its rows."""
    op = min(sparse_rows,
             key=lambda r: abs((r["density"] or 1.0) - target_density))
    d_abs = dense["metrics"]["abs_rel"]
    rel_delta = abs(op["metrics"]["abs_rel"] - d_abs) / d_abs
    checks = {
        "dense_metrics_finite": all(
            bool(np.isfinite(v)) for v in dense["metrics"].values()),
        "dense_learned": d_abs < LEARNED_ABS_REL,
        "sparse_near_10pct_exists": abs(
            (op["density"] or 1.0) - target_density) < NEAR_TARGET,
        "sparse_absrel_delta_le_1p5pct": rel_delta <= MAX_REL_DELTA,
        "oracle_disp_close": all(
            oracle[f"disp{s}_maxerr"] <= ORACLE_TOL for s in range(4)),
    }
    return {"operating_point": {"threshold": op["threshold"],
                                "density": op["density"]},
            "sparse_vs_dense_absrel_rel_delta": rel_delta,
            "checks": checks, "ok": all(checks.values())}


def main(argv=None, device=None) -> dict:
    """Runs on `device`, else on --device; returns the summary, which it
    also writes to --out."""
    from ..utils import device as device_rule
    from ..utils.config import parse_kitti_args
    from . import evaluate_depth as ed

    args = parse_args(argv)
    device = device_rule.resolve_device(device if device is not None
                                        else args.device)
    device_rule.pin_float32(device)
    ckpt = args.load_weights_folder or newest_checkpoint(args.log_dir,
                                                         args.model_name)
    base = eval_argv(args, ckpt, device)
    # evaluate_depth prefers --torch_model_path, then WMD_TORCH_MODEL_PATH,
    # to --load_weights_folder: name the checkpoint there too
    evals = base + ["--torch_model_path", ckpt]
    print(f"[self-golden] checkpoint: {ckpt}", flush=True)

    print("[self-golden] leg A: dense full-protocol eval", flush=True)
    dense = ed.main(evals)

    print("[self-golden] leg B: sparse threshold ladder", flush=True)
    sparse_rows = []
    for th in THRESHOLDS:
        r = ed.main(evals + ["--use_sparse", "--threshold", str(th)])
        sparse_rows.append({"threshold": th, "density": r["density_mean"],
                            "metrics": r["metrics"]})
        print(f"[self-golden] th={th}: density={r['density_mean']} "
              f"abs_rel={r['metrics']['abs_rel']:.4f}", flush=True)

    print("[self-golden] leg C: the device forward against the CPU's",
          flush=True)
    oracle = torch_oracle(parse_kitti_args(base), device)

    summary = {"checkpoint": ckpt, "device": str(device),
               "dense": dense["metrics"], "sparse_rows": sparse_rows}
    decision = decide(dense, sparse_rows, oracle)
    summary.update(
        operating_point=decision["operating_point"],
        sparse_vs_dense_absrel_rel_delta=decision[
            "sparse_vs_dense_absrel_rel_delta"],
        torch_oracle=oracle, checks=decision["checks"], ok=decision["ok"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    print(f"[self-golden] {'PASS' if summary['ok'] else 'FAIL'} -> "
          f"{args.out}", flush=True)
    return summary


if __name__ == "__main__":
    main()
