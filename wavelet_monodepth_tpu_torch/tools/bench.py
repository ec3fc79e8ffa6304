"""Serving benchmark of the port: the cells and result keys of the JAX
package's `bench.py`, measured with CUDA events.

KITTI ResNet18 640x192 at batch 16, random weights (the port's fan-in
init from a seeded torch.Generator), the "edge" operating point: masks
from `utils/maskgen.py` at 10% aggregate density of synthetic scenes
(seed 0, as `bench.py:127-130`) passed as `mask_override` on the default
sparse backend ("xla", masked dense). Cells, each one whole forward
(encoder + decoder, the output dict left in the model's dtype):

  dense_f32, sparse_f32, dense_bf16, sparse_bf16   the headline cells
  sparse_thresh02_f32   the decoder's own threshold masks at ratio 0.2
  batch1_dense_bf16, batch1_sparse_bf16            the B=1 latency cells
  extra rows: sparse_pallas_f32 / sparse_pallas2d_f32 (the tile-sparse
    conv kernels, float32 only), sparse_{compact,sites,capacity}_{f32,
    bf16} at compact_cap 1.0 (at 0.5 the maskgen masks overflow)

bfloat16 is the full cast of `tools/infer.py --bfloat16`: parameters, BN
statistics and the image.

Timing: CUDA events around `iters` calls after 3 warm-ups, 3 windows
interleaved over the cells (a, b, ..., b, a, ...); a cell reports the
median window with its min and max. A cell whose windows spread by more
than 10% (max / min) is measured again, up to twice; if it still
spreads, it reports null and its spread, never a number. Nothing is
cached between runs. On the CPU (`--device cpu`, for tests) the windows
are timed with the host clock.

FLOPs: `torch.utils.flop_counter.FlopCounterMode` over one dense bf16
forward. It counts convolutions and matmuls only (no BN, pads,
elementwise ops), so it is below XLA's cost analysis, which `bench.py`
uses; the two are not compared.

Prints ONE JSON line: {"metric", "value" (sparse_bf16 frames/s),
"unit", "vs_baseline" (sparse_bf16 / dense_bf16), "extra": {bench.py's
keys, the cells with their windows, the extra rows, "device": the
card's name and power limit}}.

Usage (on the card):
  python -m wavelet_monodepth_tpu_torch.tools.bench [--batch 16]
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import time

import torch

BATCH = 16
H, W = 192, 640
DENSITY = 0.10
TH_CONT = 0.2            # the threshold cell's ratio (bench.py's)
MAX_SPREAD = 1.10        # max / min of a cell's windows
RETRIES = 2
COMPACTED = ("compact", "sites", "capacity")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serving benchmark (the port's "
                                            "twin of bench.py)")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--height", type=int, default=H)
    p.add_argument("--width", type=int, default=W)
    p.add_argument("--iters", type=int, default=10,
                   help="calls per window at the batch; B=1 takes 3x")
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--no-extra", dest="extra", action="store_false",
                   help="skip the kernel and compacted backends' rows")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def device_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(dev.index or 0)],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    name, limit = [s.strip() for s in line.split(",")]
    return {"name": name, "power_limit": limit,
            "torch_name": torch.cuda.get_device_name(dev)}


def _windows(cells: dict, iters: dict, windows: int, dev,
             warmup: int = 3) -> dict:
    """{cell: [ms per call of each window]}, the cells interleaved, after
    `warmup` calls of each."""
    cuda = dev.type == "cuda"
    for fn in cells.values():
        for _ in range(warmup):
            fn()
    if cuda:
        torch.cuda.synchronize(dev)
    ms = {k: [] for k in cells}
    order = list(cells)
    for wi in range(windows):
        for k in (order if wi % 2 == 0 else order[::-1]):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters[k]):
                    cells[k]()
                end.record()
                end.synchronize()
                ms[k].append(start.elapsed_time(end) / iters[k])
            else:
                t0 = time.perf_counter()
                for _ in range(iters[k]):
                    cells[k]()
                ms[k].append((time.perf_counter() - t0) * 1e3 / iters[k])
    return ms


def measure(cells: dict, iters: dict, windows: int, dev,
            warmup: int = 3) -> dict:
    """{cell: {"ms", "ms_min", "ms_max", "spread", "attempts"}}; "ms" is
    the median window, or None when the windows still spread past
    MAX_SPREAD after RETRIES re-measurements."""
    out = {}
    todo = dict(cells)
    for attempt in range(1 + RETRIES):
        if not todo:
            break
        got = _windows(todo, iters, windows, dev, warmup)
        for k, v in got.items():
            spread = max(v) / min(v)
            out[k] = {"ms": statistics.median(v), "ms_min": min(v),
                      "ms_max": max(v), "spread": spread,
                      "windows": v, "attempts": attempt + 1}
        todo = {k: todo[k] for k in got if out[k]["spread"] > MAX_SPREAD}
    for k in todo:
        out[k]["ms"] = None
    return out


def build(dev, seed: int = 0):
    """(f32 encoder, f32 decoder, bf16 encoder, bf16 decoder), eval mode,
    random weights from `seed`."""
    from ..models.decoders_kitti import KittiWaveletDecoder
    from ..models.layers import init_params
    from ..models.resnet import ResnetEncoder
    from ..utils.precision import cast_floats
    gen = torch.Generator().manual_seed(seed)
    enc = init_params(ResnetEncoder(18), gen).to(dev).eval()
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), gen).to(dev).eval()
    return (enc, dec, cast_floats(copy.deepcopy(enc), torch.bfloat16),
            cast_floats(copy.deepcopy(dec), torch.bfloat16))


def main(argv=None, device=None) -> dict:
    """Runs the cells on `device`, else on --device; prints the result
    line and returns it."""
    from ..ops.sparse import compute_density
    from ..utils import maskgen as mg
    from ..utils import device as device_rule

    args = parse_args(argv)
    dev = device_rule.resolve_device(device if device is not None
                                     else args.device)
    device_rule.pin_float32(dev)
    b, h, w = args.batch, args.height, args.width
    enc, dec, encb, decb = build(dev)

    disp = mg.synthetic_depth_scene(b, h, w, seed=0)
    masks_np, ratio, _ = mg.masks_at_density(disp, DENSITY)
    x = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    xb = x.to(torch.bfloat16)
    masks = {i: torch.from_numpy(m).to(dev) for i, m in masks_np.items()}
    models = {"f32": (enc, dec, x), "bf16": (encb, decb, xb)}

    def cell(dtype, mode, backend=False, cap=0.5, batch=None):
        e, d, img = models[dtype]
        mo = masks
        if batch is not None:
            img = img[:batch]
            mo = {i: m[:batch] for i, m in masks.items()}

        @torch.inference_mode()
        def run():
            feats = e(img)
            if mode == "dense":
                return d(feats)
            if mode == "edge":
                return d(feats, thresh_ratio=ratio, mask_override=mo,
                         use_pallas=backend, compact_cap=cap)
            return d(feats, thresh_ratio=TH_CONT, use_pallas=backend)
        return run

    cells = {"dense_f32": cell("f32", "dense"),
             "sparse_f32": cell("f32", "edge"),
             "dense_bf16": cell("bf16", "dense"),
             "sparse_bf16": cell("bf16", "edge"),
             "sparse_thresh02_f32": cell("f32", "threshold")}
    extra_rows = {}
    if args.extra:
        extra_rows = {f"sparse_{k}_f32": cell("f32", "edge", k)
                      for k in ("pallas", "pallas2d")}
        for k in COMPACTED:
            for dt in ("f32", "bf16"):
                extra_rows[f"sparse_{k}_{dt}_cap1.0"] = cell(dt, "edge", k,
                                                            1.0)
    batch1 = {"batch1_dense_bf16": cell("bf16", "dense", batch=1),
              "batch1_sparse_bf16": cell("bf16", "edge", batch=1)}

    timed = measure({**cells, **extra_rows},
                    dict.fromkeys({**cells, **extra_rows}, args.iters),
                    args.windows, dev)
    timed.update(measure(batch1, dict.fromkeys(batch1, 3 * args.iters),
                         args.windows, dev))

    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        cells["dense_bf16"]()
    flops = float(counter.get_total_flops())
    with torch.inference_mode():
        dens = float(compute_density(dec(enc(x), thresh_ratio=ratio,
                                         mask_override=masks)))

    def fps(name):
        ms = timed[name]["ms"]
        return None if ms is None else b * 1e3 / ms

    def ratio_of(a, c):
        return None if a is None or c is None else a / c

    dense_bf16 = timed["dense_bf16"]["ms"]
    result = {
        "metric": f"kitti_r18_{w}x{h}_sparse_fps",
        "value": fps("sparse_bf16"),
        "unit": "frames/sec",
        "vs_baseline": ratio_of(fps("sparse_bf16"), fps("dense_bf16")),
        "extra": {
            "dtype": "bf16 (the full cast of tools/infer.py --bfloat16)",
            "dense_bf16_fps": fps("dense_bf16"),
            "dense_f32_fps": fps("dense_f32"),
            "sparse_f32_fps": fps("sparse_f32"),
            "sparse_f32_vs_dense_f32": ratio_of(fps("sparse_f32"),
                                                fps("dense_f32")),
            "sparse_thresh02_f32_fps": fps("sparse_thresh02_f32"),
            "density": dens,
            "mask_source": "true-DWT edge masks of synthetic scenes "
                           "(utils/maskgen.py, seed 0)",
            "sparse_backend": "xla (masked dense, cuDNN)",
            "batch": b,
            "res": [h, w],
            "measurement": "CUDA events, median of 3 interleaved windows"
                           if dev.type == "cuda" else
                           "host clock (CPU run), median of the windows",
            "device": device_info(dev),
            "batch1_ms_dense_bf16": timed["batch1_dense_bf16"]["ms"],
            "batch1_ms_sparse_bf16": timed["batch1_sparse_bf16"]["ms"],
            "gflop_per_frame": flops / b / 1e9,
            "flop_counter": "torch.utils.flop_counter (convs and matmuls)",
            "tflops_effective_dense_bf16": (
                None if dense_bf16 is None
                else flops / (dense_bf16 / 1e3) / 1e12),
            "cells": {k: timed[k] for k in list(cells) + list(batch1)},
            "extra_rows": {k: {**timed[k], "fps": fps(k)}
                           for k in extra_rows},
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
