"""A/B timing of the tile-sparse conv (K1, K4), the banded-warp forward
(K3), the fused wave stage (K2) and the tile scatter (K6) between source
trees of this repo, on one CUDA card.

Each tree runs in its own process, which imports that tree's
`wavelet_monodepth_tpu_torch` and builds that tree's kernels; the trees
run in the order given, so `A B B A` interleaves two of them. Inputs come
from seeded generators and are the same for every tree. Per run it
prints one JSON line:

  conv  per decoder conv of one B=16 and one B=1 sparse forward at the
        10% maskgen point (chip_smoke.PATH_CONVS, the heads' conv twice),
        each wrapper's median ms (CUDA events, 3 interleaved windows of
        20 calls), and the 12-launch sums per wrapper;
  warp  the K3 forward per launch at (12, 192, 640, 3) on a stereo grid of
        maskgen depth (50 calls queued behind a device-side sleep, median
        of 3 windows), with the tree's own band choice and, where the
        tree takes one, each of --warp-rows output rows per block; and
        F.grid_sample on the same grid;
  fused K2's bare launch (`fused_stage._launch`, padding and flags done
        beforehand) per scale 3/2/1 at B=16 and B=1 on chip_smoke's stage
        inputs (a seeded random net's decoder under the 10% maskgen
        masks), median of 3 windows of 5 (B=16) or 20 (B=1) calls, and
        the B=16 sum;
  scatter K6 (`blockio._launch_scatter`: the canvas's allocation and the
        kernel, with the canvas zeroing where the tree's wrapper does it)
        over the 6 block_scatter calls recorded from one B=16 compact
        forward (10% maskgen masks, compact_cap 0.5), in float32 and
        bf16: 20 runs of the 6 calls queued behind a device-side sleep,
        median of 3 windows;
  compact the wall ms (host clock, synchronised) of one B=16 compact
        forward at compact_cap 1.0, float32 and bf16, median of 3 windows
        of 10 after 3 warm-ups, and its synchronising calls
        (torch.cuda.set_sync_debug_mode), those inside block_scatter apart.

Every tree takes its inputs and timer from the chip_smoke.py of the
tree this script runs from, so another tree needs only its package.
The last line is a summary: per tree, the medians over its runs.

Usage, from the repo root on a machine with a card (any git-ignored
directory holds the other tree):
  mkdir -p _archive/parent && git archive HEAD~1 | tar x -C _archive/parent
  python3 wavelet_monodepth_tpu_torch/tools/kernel_ab.py \\
      _archive/parent . . _archive/parent [--warp-rows 2 4 9] \\
      [--parts conv warp fused scatter compact]
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


PARTS = ("conv", "warp", "fused", "scatter", "compact")


def worker(tree: str, warp_rows, parts) -> dict:
    """Times `tree`'s kernels in this process (call once per process)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)   # the running tree's
    spec.loader.exec_module(cs)
    import wavelet_monodepth_tpu_torch as pkg
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    if not os.path.abspath(pkg.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not {tree}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"tree": tree, "card": cs.card_line()}
    if "conv" in parts:
        out.update(time_conv(cs, dev))
    if "warp" in parts:
        out["warp"] = time_warp(cs, dev, warp_rows)
    if {"fused", "scatter", "compact"} & set(parts):
        enc, dec = cs.build_models(dev)
        if "fused" in parts:
            out["fused_ms"] = time_fused(cs, dev, enc, dec)
        if {"scatter", "compact"} & set(parts):
            out.update(time_compact(cs, dev, enc, dec, parts))

    from wavelet_monodepth_tpu_torch.kernels import build
    out["ptxas"] = {name: [ln.split("info    :")[-1].strip()
                           for ln in info["ptxas"].splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, info in build.build_info.items()}
    return out


def time_conv(cs, dev) -> dict:
    import torch
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    nl = {"elu": tsc.elu, "sigmoid": tsc.sigmoid}
    keys = ("conv3x3_tile_sparse", "conv3x3_tile_sparse_2d")
    g = torch.Generator().manual_seed(2)
    convs, sums = [], {}
    for batch in (16, 1):
        _, _, _, _, stage = cs.edge_stage_masks(batch)
        sums[batch] = {k: 0.0 for k in keys}
        for h, w, cin, cout, epi, (i, mk), conv in cs.PATH_CONVS:
            x = torch.randn(batch, h, w, cin, generator=g).to(dev)
            wt = (torch.randn(3, 3, cin, cout, generator=g) * 0.05).to(dev)
            b = torch.zeros(cout, device=dev)
            m = stage[i][mk].to(dev)
            with torch.inference_mode():
                t = cs.time_variants({k: (lambda k=k: getattr(tsc, k)(
                    x, wt, b, m, "reflect", nl[epi])) for k in keys},
                    iters=20)
            reps = 2 if "pos/neg" in conv else 1
            for k in keys:
                sums[batch][k] += reps * t[k]["ms_median"]
            convs.append({"conv": conv, "shape": [batch, h, w, cin, cout],
                          **{k: t[k]["ms_median"] for k in keys}})
    return {"conv": convs, "conv_sum_ms": sums[16],
            "conv_sum_ms_b1": sums[1]}


def time_warp(cs, dev, warp_rows) -> dict:
    import torch
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    n, h, w, c = cs.TRAIN_B, cs.H, cs.W, 3
    g = torch.Generator().manual_seed(21)
    img = torch.rand(n, h, w, c, generator=g).to(dev)
    scene = torch.from_numpy(mg.synthetic_depth_scene(n, h, w, seed=3)).to(dev)
    grid = cs.stereo_grid(0.58 * w * 0.1 / (1.0 + scene * 0.03 * w), 0.1)
    xs, yr = warp.banded_coords(grid, h, w)
    img_nchw = img.permute(0, 3, 1, 2)
    variants = {"kernel": lambda: warp._launch_fwd(img, xs, yr),
                "library_grid_sample": lambda: F.grid_sample(
                    img_nchw, grid, padding_mode="border",
                    align_corners=False)}
    default_rows = None
    if "rows" in inspect.signature(warp._launch_fwd).parameters:
        default_rows = warp.band_rows(img)
        for r in warp_rows:
            variants[f"kernel_rows{r}"] = (
                lambda r=r: warp._launch_fwd(img, xs, yr, r))
    ref = warp.banded_warp_plain(img, xs, yr)
    errs = {k: float((f() - ref).abs().max()) for k, f in variants.items()
            if k.startswith("kernel")}
    with torch.no_grad():
        t = cs.time_variants(variants, iters=50, queue_ahead=True)
    return {"shape": [n, h, w, c], "default_rows": default_rows,
            "ms_median": {k: v["ms_median"] for k, v in t.items()},
            "ms_min": {k: v["ms_min"] for k, v in t.items()},
            "ms_max": {k: v["ms_max"] for k, v in t.items()},
            "max_abs_err_vs_plain": errs}


def time_fused(cs, dev, enc, dec) -> dict:
    import torch
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    fused = {}
    with torch.inference_mode():
        for batch in (16, 1):
            stage = cs.fused_inputs(enc, dec, dev, batch)
            for i, (x, skip, yl, mask) in stage.items():
                params = dec.stage_params(i)
                inp = fs._stage_inputs(x, skip, yl, mask, 8, 64)
                t_f = cs.time_variants(
                    {"kernel": lambda: fs._launch(inp, params, i, 8, 64)},
                    iters=5 if batch == 16 else 20)
                fused[f"b{batch}_scale{i}"] = t_f["kernel"]["ms_median"]
    fused["b16_sum"] = sum(fused[f"b16_scale{i}"] for i in cs.FUSED_SCALES)
    return fused


def time_compact(cs, dev, enc, dec, parts) -> dict:
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = cs.edge_stage_masks(16)
    raw = {i: m.to(dev) for i, m in raw.items()}
    scatter, compact = {}, {}
    for dtype, (e, d) in ((torch.float32, (enc, dec)),
                          (torch.bfloat16, cs.bf16_copies(enc, dec))):
        key = str(dtype).replace("torch.", "")
        img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev, dtype)
        if "scatter" in parts:
            calls = [args for name, args, _ in cs.record_block_io(
                cs.compact_forward(e, d, img, raw, ratio))
                if name == "block_scatter"]
            with torch.inference_mode():
                t = cs.time_variants({"kernel": lambda: [
                    bio._launch_scatter(*args) for args in calls]},
                    iters=20, queue_ahead=True)
            scatter[key] = t["kernel"]
            del calls
        if "compact" in parts:
            fwd = cs.compact_forward(e, d, img, raw, ratio, cap=1.0)
            compact[key] = {**wall_ms(fwd), **cs.count_syncs(fwd)}
    return {k: v for k, v in (("scatter_ms", scatter), ("compact", compact))
            if v}


def wall_ms(run, iters: int = 10, windows: int = 3) -> dict:
    """Host-clock ms per run() (synchronised at each window's end) after
    3 warm-ups: median, min and max of the windows."""
    import time
    import torch
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    ms = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / iters)
    return {"ms_median": statistics.median(ms), "ms_min": min(ms),
            "ms_max": max(ms)}


def summarize(mine: list) -> dict:
    """One tree's runs: the median over them of each timed number."""
    def med(get):
        return statistics.median(get(r) for r in mine)

    first, out = mine[0], {"runs": len(mine)}
    for k in first.get("conv_sum_ms", {}):
        out[f"{k}_sum_ms"] = med(lambda r: r["conv_sum_ms"][k])
        out[f"{k}_sum_ms_b1"] = med(lambda r: r["conv_sum_ms_b1"][k])
    if "warp" in first:
        out["warp_fwd_ms"] = {k: med(lambda r: r["warp"]["ms_median"][k])
                              for k in first["warp"]["ms_median"]}
    if "fused_ms" in first:
        out["fused_ms"] = {k: med(lambda r: r["fused_ms"][k])
                           for k in first["fused_ms"]}
    if "scatter_ms" in first:
        out["scatter_ms"] = {k: med(lambda r: r["scatter_ms"][k]["ms_median"])
                             for k in first["scatter_ms"]}
    if "compact" in first:
        out["compact_ms"] = {k: med(lambda r: r["compact"][k]["ms_median"])
                             for k in first["compact"]}
        out["compact_syncs"] = {k: [r["compact"][k]["syncs"] for r in mine]
                                for k in first["compact"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="tree roots, in run order")
    ap.add_argument("--warp-rows", type=int, nargs="*", default=[],
                    help="K3 forward output rows per block to time besides "
                         "the tree's default (trees that take a choice)")
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS),
                    help="what to time (default: all)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.trees[0], args.warp_rows, args.parts)),
              flush=True)
        return 0
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--warp-rows", *map(str, args.warp_rows),
             "--parts", *args.parts],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"kernel_ab: the run of {tree} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {tree: summarize([r for r in runs if r["tree"] == tree])
               for tree in dict.fromkeys(r["tree"] for r in runs)}
    print(json.dumps({"summary": summary, "card": runs[0]["card"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
