"""Benchmark grid over the published configs (BASELINE.md rows): KITTI
R18/R50 x 640x192/1024x320 and NYU DenseNet161 640x480, dense vs
masked-sparse, float32 vs bfloat16.

Counterpart of `wavelet_monodepth_tpu/tools/bench_grid.py`, with its
flags, configs, variants and row keys, plus --device. Random weights
from a seeded torch.Generator (seed 0). KITTI decodes at the 10%
operating point of `bench.py`: masks from `utils/maskgen.py` (true-DWT
edges of synthetic scenes) at 10% aggregate density, passed as the
decoder's `mask_override`; NYU at its own threshold (--nyu_threshold,
0.05) on a uniform random image. The sparse variants run the decoder's
default backend (masked dense), as in JAX; bfloat16 is the full cast of
`--bfloat16` (`utils/precision.py`). Density: `ops/sparse.
compute_density` of the float32 sparse forward, unrounded.

Timing: `tools/bench.measure` (CUDA events; the host clock on the CPU),
the four variants of a config interleaved over --windows windows; a row
reports the median window and its [min, max] per frame. JAX's slope
timer is not ported (ROADMAP queue 1 item 7): --k0 is the number of
warm-up calls per variant and --k1 the number of calls per window
(JAX: the two loop lengths of the slope); --reps is accepted for JAX's
command lines and unused. A variant whose windows still spread past
`bench.MAX_SPREAD` after the re-measurements reports null; one that
raises reports `<variant>_error` and the rest of the grid goes on.

Emits one JSON line per (config, variant), the row, and a final
{"grid": [rows]} line.

  python -m wavelet_monodepth_tpu_torch.tools.bench_grid [--batch 16]
      [--threshold 0.2] [--configs kitti_r18_640x192 ...] [--out path]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json

import torch

CONFIGS = {
    "kitti_r18_640x192": dict(kind="kitti", layers=18, h=192, w=640),
    "kitti_r50_640x192": dict(kind="kitti", layers=50, h=192, w=640),
    "kitti_r18_1024x320": dict(kind="kitti", layers=18, h=320, w=1024),
    "kitti_r50_1024x320": dict(kind="kitti", layers=50, h=320, w=1024),
    "nyu_dense161_640x480": dict(kind="nyu", layers=161, h=480, w=640),
}
VARIANTS = ("dense_f32", "sparse_f32", "dense_bf16", "sparse_bf16")
KITTI_DENSITY = 0.10


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="bench grid")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--nyu_threshold", type=float, default=0.05)
    p.add_argument("--k0", type=int, default=1,
                   help="warm-up calls per variant")
    p.add_argument("--k1", type=int, default=9,
                   help="calls per measurement window")
    p.add_argument("--reps", type=int, default=2,
                   help="JAX's slope repetitions; unused here")
    p.add_argument("--windows", type=int, default=3,
                   help="measurement windows per variant; rows report "
                        "the median + [min, max]")
    p.add_argument("--configs", nargs="+", default=list(CONFIGS))
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def config_inputs(cfg: dict, batch: int, nyu_threshold: float, dev):
    """(encoder, decoder, image, masks or None, thresh) of one config, the
    modules in eval mode on `dev` with seeded weights."""
    from ..models.decoders_kitti import KittiWaveletDecoder
    from ..models.decoders_nyu import NyuDecoderWave
    from ..models.densenet import NUM_CH_ENC, DenseNet161Encoder
    from ..models.layers import init_params
    from ..models.resnet import ResnetEncoder
    from ..utils import maskgen as mg

    gen = torch.Generator().manual_seed(0)
    masks = None
    if cfg["kind"] == "kitti":
        encoder = ResnetEncoder(num_layers=cfg["layers"])
        decoder = KittiWaveletDecoder(num_ch_enc=encoder.num_ch_enc)
        # the trained-model operating point: edge-structured masks from
        # the true DWT of synthetic scenes (tools/bench.py)
        disp = mg.synthetic_depth_scene(batch, cfg["h"], cfg["w"], seed=0)
        masks_np, thresh, _ = mg.masks_at_density(disp, KITTI_DENSITY)
        masks = {i: torch.from_numpy(m).to(dev)
                 for i, m in masks_np.items()}
        x = torch.from_numpy(mg.scene_image(disp, seed=0))
    else:
        encoder = DenseNet161Encoder()
        decoder = NyuDecoderWave(num_ch_enc=NUM_CH_ENC)
        thresh = nyu_threshold
        x = torch.rand((batch, cfg["h"], cfg["w"], 3), generator=gen)
    init_params(encoder, gen)
    init_params(decoder, gen)
    return (encoder.to(dev).eval(), decoder.to(dev).eval(), x.to(dev),
            masks, thresh)


def variant_calls(encoder, decoder, x, masks, thresh) -> dict:
    """{variant: one forward}: dense and sparse, float32 and the bfloat16
    cast (copies of the modules)."""
    from ..utils.precision import cast_floats
    encb = cast_floats(copy.deepcopy(encoder), torch.bfloat16)
    decb = cast_floats(copy.deepcopy(decoder), torch.bfloat16)
    models = {"f32": (encoder, decoder, x),
              "bf16": (encb, decb, x.to(torch.bfloat16))}

    def call(dtype, sparse):
        enc, dec, img = models[dtype]

        @torch.inference_mode()
        def run():
            feats = enc(img)
            if not sparse:
                return dec(feats)
            if masks is None:
                return dec(feats, thresh_ratio=thresh)
            return dec(feats, thresh_ratio=thresh, mask_override=masks)
        return run

    return {f"{mode}_{dt}": call(dt, mode == "sparse")
            for dt in ("f32", "bf16") for mode in ("dense", "sparse")}


def grid_row(name: str, args, dev) -> dict:
    """One config's row (printing each variant's line as it goes)."""
    from ..ops.sparse import compute_density
    from .bench import measure

    cfg = CONFIGS[name]
    encoder, decoder, x, masks, thresh = config_inputs(
        cfg, args.batch, args.nyu_threshold, dev)
    calls = variant_calls(encoder, decoder, x, masks, thresh)
    dens = float(compute_density(calls["sparse_f32"]()))
    row = {"config": name, "batch": args.batch, "density": dens,
           "threshold": thresh}
    runnable = {}
    for v in VARIANTS:
        try:
            calls[v]()
            runnable[v] = calls[v]
        except Exception as e:     # noqa: BLE001 — record and move on
            row[v + "_error"] = f"{type(e).__name__}: {e}"[:200]
    timed = measure(runnable, dict.fromkeys(runnable, args.k1),
                    args.windows, dev, warmup=args.k0) if runnable else {}
    for v in VARIANTS:
        if v in timed:
            t = timed[v]
            row[v + "_us_per_frame"] = (None if t["ms"] is None
                                        else t["ms"] / args.batch * 1e3)
            row[v + "_us_minmax"] = [t["ms_min"] / args.batch * 1e3,
                                     t["ms_max"] / args.batch * 1e3]
        print(json.dumps(row), flush=True)
    dense = row.get("dense_f32_us_per_frame")
    sparse = row.get("sparse_f32_us_per_frame")
    row["sparse_over_dense_f32"] = (dense / sparse if dense and sparse
                                    else None)
    print(json.dumps(row), flush=True)
    return row


def main(argv=None, device=None) -> list:
    """Runs the grid on `device`, else on --device; returns the rows."""
    from ..utils import device as device_rule

    args = parse_args(argv)
    dev = device_rule.resolve_device(device if device is not None
                                     else args.device)
    device_rule.pin_float32(dev)
    results = []
    for name in args.configs:
        results.append(grid_row(name, args, dev))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"grid": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
