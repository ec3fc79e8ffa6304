"""Sparsity sweep: the score-vs-latency curve as one command (the
reference's `KITTI/sparsity_test_notebook.ipynb` and
`NYUv2/sparsity_test_notebook.ipynb`, with card latency).

Counterpart of `wavelet_monodepth_tpu/tools/sparsity_sweep.py`, with its
flags, weight sources, mask families and JSON keys, so that the two
packages' files plot together (`tools/plot_sparsity_curve.py`).

Weight sources (--weights, repeatable):
  random      the fan-in init from a seeded torch.Generator (seed 0)
  synthetic   that init after --train_steps supervised steps (Adam,
              lr 1e-4, L1 on ("disp", 0), float32) on maskgen's
              piecewise-smooth scenes of seed 100, so the thresholded
              coefficients sit on depth edges as a trained model's do;
              scored on the seed-0 scenes' GT disparity. BN runs on its
              running statistics, which the loop trains too, as JAX's
  torch       a reference checkpoint: a folder with encoder.pth and
              depth.pth (KITTI) or a model.pth (NYU, DenseNet161),
              through `tools/torch_import.py`

Mask families per source: the decoder's own thresholded coefficients
(--thresholds) and, for KITTI, maskgen's edge masks bisected to exact
densities (--densities, passed as `mask_override`). --dataset nyu sweeps
NyuDecoderWave, whose output is at half the input's resolution (the GT
is block-averaged to it) and which takes no edge masks. The decoder runs
its masked-dense backend, as JAX's sweep does; --bfloat16 casts the
weights (after any training) and the images.

Latency: CUDA events, the median of 3 interleaved windows of K1 calls
after K0 warm-up calls (--k K0 K1) per row (`tools/bench.py`'s
measure, which re-measures a row whose windows spread by more than 10%
and then gives null with "latency_unreliable"), in place of JAX's slope
method; on the CPU the host clock. Runs on --device (cuda, which raises without a card,
or cpu).

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.sparsity_sweep \\
      --weights random synthetic --out sparsity_curve.json
"""

from __future__ import annotations

import argparse
import copy
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="score-vs-latency sweep")
    p.add_argument("--dataset", choices=["kitti", "nyu"], default="kitti",
                   help="nyu sweeps DecoderWave (the NYUv2 notebook); "
                        "--torch_model_path is then the model.pth file")
    p.add_argument("--weights", nargs="+", default=["random", "synthetic"],
                   choices=["random", "synthetic", "torch"])
    p.add_argument("--torch_model_path", type=str, default=None)
    p.add_argument("--image", type=str, default=None,
                   help="score on a real image instead of synthetic "
                        "scenes (no GT axis)")
    p.add_argument("--num_layers", type=int, default=18)
    p.add_argument("--encoder_type", default="densenet",
                   choices=["densenet", "mobilenet_light"],
                   help="NYU encoder (--dataset nyu)")
    p.add_argument("--height", type=int, default=None,
                   help="default 192 (kitti) / 480 (nyu)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--thresholds", nargs="+", type=float,
                   default=[-1, 0.01, 0.02, 0.05, 0.1, 0.2])
    p.add_argument("--densities", nargs="+", type=float,
                   default=[0.05, 0.10, 0.20, 0.35])
    p.add_argument("--train_steps", type=int, default=300,
                   help="supervised steps for --weights synthetic")
    p.add_argument("--bfloat16", action="store_true",
                   help="sweep in bf16 (weights and images cast)")
    p.add_argument("--k", nargs=2, type=int, default=(2, 18),
                   metavar=("K0", "K1"),
                   help="warm-up calls and calls per timing window")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.height is None:
        args.height = 192 if args.dataset == "kitti" else 480
    if args.width is None:
        args.width = 640
    if args.torch_model_path and "torch" not in args.weights:
        print("note: --torch_model_path given; adding 'torch' to --weights")
        args.weights = list(args.weights) + ["torch"]
    if "torch" in args.weights:
        if not args.torch_model_path:
            raise SystemExit("--weights torch needs --torch_model_path")
        if args.dataset == "nyu" and args.encoder_type != "densenet":
            raise SystemExit(
                "--weights torch on NYU supports only --encoder_type "
                "densenet (the published checkpoints; the importer has "
                f"no {args.encoder_type} mapping)")
    return args


def build_model(args):
    """(encoder, decoder, model name), fan-in init from seed 0."""
    import torch
    from ..models.layers import init_params
    gen = torch.Generator().manual_seed(0)
    if args.dataset == "kitti":
        from ..models.decoders_kitti import KittiWaveletDecoder
        from ..models.resnet import ResnetEncoder
        encoder = ResnetEncoder(args.num_layers)
        decoder = KittiWaveletDecoder(encoder.num_ch_enc)
        name = f"resnet{args.num_layers} + KITTI wavelet decoder"
    else:
        from ..models.decoders_nyu import NyuDecoderWave
        if args.encoder_type == "densenet":
            from ..models.densenet import DenseNet161Encoder
            encoder = DenseNet161Encoder(normalize_input=False)
        else:
            from ..models.mobilenetv2 import MobileNetV2Encoder
            encoder = MobileNetV2Encoder(use_last_layer=False)
        decoder = NyuDecoderWave(encoder.num_ch_enc, decoder_width=0.5)
        name = f"{args.encoder_type} + NYU DecoderWave"
    return init_params(encoder, gen), init_params(decoder, gen), name


def load_torch_weights(args, encoder, decoder) -> None:
    """A reference checkpoint into the modules (strict)."""
    from . import torch_import as ti
    if args.dataset == "kitti":
        sds = ti.load_reference_checkpoint(args.torch_model_path)
    else:
        sds = ti.load_nyu_model_pth(args.torch_model_path)
    ti.load_state_dicts(encoder, decoder, *sds)


def fit_to_output(arr, out_hw):
    """Block-average an (N, H, W, C) array to the decoder's output size
    (exact integer factors only)."""
    n, hh, ww, c = arr.shape
    h, w = out_hw
    if (hh, ww) == (h, w):
        return arr
    return arr.reshape(n, h, hh // h, w, ww // w, c).mean((2, 4))


def _bn_eval_differentiable(bn, x):
    """flax's BatchNorm on running statistics,
    (x - mean) * (scale * rsqrt(var + eps)) + bias, differentiable in the
    statistics too (F.batch_norm's eval mode is not)."""
    import torch
    shape = (1, -1, 1, 1)
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return ((x - bn.running_mean.view(shape)) * mul.view(shape)
            + bn.bias.view(shape))


def synthetic_train(encoder, decoder, args, out_hw, dev, steps: int):
    """Supervised L1-on-disparity training on seed-100 scenes (not the
    seed-0 scoring batch), float32, Adam lr 1e-4, in place; returns the
    per-step losses. JAX's loop applies the encoder without batch
    statistics and differentiates its whole variable tree, so Adam moves
    the BN running statistics as well as the parameters: here too, each
    BN runs on its statistics with a differentiable formula for the
    loop."""
    import types

    import torch
    from ..utils import maskgen as mg
    train_disp = mg.synthetic_depth_scene(args.batch, args.height,
                                          args.width, seed=100)
    xs = torch.from_numpy(mg.scene_image(train_disp, seed=100)).to(dev)
    ys = torch.from_numpy(fit_to_output(train_disp, out_hw)).to(dev)
    encoder.eval()
    decoder.eval()
    bns = [m for m in encoder.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    stats = [t for m in bns for t in (m.running_mean, m.running_var)]
    params = (list(encoder.parameters()) + list(decoder.parameters())
              + stats)
    for m in bns:
        m.forward = types.MethodType(_bn_eval_differentiable, m)
    for t in stats:
        t.requires_grad_(True)
    opt = torch.optim.Adam(params, lr=1e-4)
    losses = []
    try:
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = (decoder(encoder(xs))[("disp", 0)] - ys).abs().mean()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    finally:
        for m in bns:
            del m.forward
        for t in stats:
            t.requires_grad_(False)
            t.grad = None
    losses = [float(v) for v in losses]
    if losses:
        print(f"synthetic training: {steps} steps, final L1 {losses[-1]:.4f}")
    return losses


def main(argv=None, device=None) -> dict:
    import numpy as np
    import torch

    from ..ops.sparse import compute_density
    from ..utils import device as device_rule
    from ..utils import maskgen as mg
    from ..utils.precision import cast_floats
    from .bench import device_info, measure

    args = parse_args(argv)
    dev = device_rule.resolve_device(device if device is not None
                                     else args.device)
    device_rule.pin_float32(dev)
    encoder, decoder, model_name = build_model(args)
    encoder.to(dev).eval()
    decoder.to(dev).eval()
    if args.dataset == "nyu" and args.densities:
        print("note: the edge-mask family needs mask_override at the "
              "KITTI decoder's scales: skipping --densities for nyu")
        args.densities = []

    # inputs: synthetic scenes with GT disparity, or one real image
    gt_disp = mg.synthetic_depth_scene(args.batch, args.height, args.width,
                                       seed=0)
    if args.image:
        from PIL import Image
        img = Image.open(args.image).convert("RGB").resize(
            (args.width, args.height), Image.LANCZOS)
        one = np.asarray(img, np.float32) / 255.0
        x_np = np.ascontiguousarray(np.broadcast_to(
            one, (args.batch,) + one.shape))
        gt = None
    else:
        x_np = mg.scene_image(gt_disp, seed=0)
        gt = gt_disp
    x = torch.from_numpy(x_np).to(dev)
    with torch.inference_mode():
        out_hw = tuple(decoder(encoder(x[:1]))[("disp", 0)].shape[1:3])
    if gt is not None:
        gt = fit_to_output(gt, out_hw)

    sources = {}
    for src in dict.fromkeys(args.weights):
        enc, dec = copy.deepcopy(encoder), copy.deepcopy(decoder)
        if src == "synthetic":
            synthetic_train(enc, dec, args, out_hw, dev, args.train_steps)
        elif src == "torch":
            load_torch_weights(args, enc, dec)
        sources[src] = (enc.eval(), dec.eval())

    dtype = torch.bfloat16 if args.bfloat16 else torch.float32
    xd = x.to(dtype)
    k0, k1 = args.k

    def score(disp, dense_disp):
        r = {"disp_mae_vs_dense": float(np.abs(disp - dense_disp).mean())}
        denom = np.maximum(np.abs(dense_disp), 1e-3)
        r["abs_rel_vs_dense"] = float(
            (np.abs(disp - dense_disp) / denom).mean())
        if gt is not None:
            # valid GT only (sky disparity ~0 would dominate)
            valid = gt > 0.05
            r["abs_rel_vs_gt"] = float(
                (np.abs(disp - gt)[valid] / gt[valid]).mean())
        return r

    def gflops(out):
        return float(out[("total_ops", -1)].float().mean()) / 1e9

    def host_disp(out):
        return out[("disp", 0)].float().cpu().numpy()

    rows = []
    for src, (enc, dec) in sources.items():
        if args.bfloat16:
            cast_floats(enc, torch.bfloat16)
            cast_floats(dec, torch.bfloat16)

        def call(mode, thresh=None, mo=None, enc=enc, dec=dec):
            @torch.inference_mode()
            def run():
                feats = enc(xd)
                if mode == "dense":
                    return dec(feats)
                if mode == "edge":
                    return dec(feats, thresh_ratio=thresh, mask_override=mo)
                return dec(feats, thresh_ratio=thresh)
            return run

        # (row, its call): dense, the thresholds, the edge masks
        cells = []
        dense_out = call("dense")()
        dense_disp = host_disp(dense_out)
        # the dense decode carries no op counters; thresh=-1 is dense
        # bit for bit with them
        counted = call("threshold", -1.0)()
        row = {"weights": src, "mask_family": "dense", "threshold": None,
               "density": 1.0, "gflops": gflops(counted)}
        row.update(score(dense_disp, dense_disp))
        cells.append((row, call("dense")))
        for th in args.thresholds:
            fn = call("threshold", float(th))
            out = fn()
            row = {"weights": src, "mask_family": "threshold",
                   "threshold": th, "density": float(compute_density(out)),
                   "gflops": gflops(out)}
            row.update(score(host_disp(out), dense_disp))
            cells.append((row, fn))
        for dens in args.densities:
            masks_np, ratio, actual = mg.masks_at_density(gt_disp, dens)
            mo = {i: torch.from_numpy(m).to(dev) for i, m in masks_np.items()}
            fn = call("edge", float(ratio), mo)
            out = fn()
            row = {"weights": src, "mask_family": "edge",
                   "threshold": ratio, "target_density": dens,
                   "density": float(actual), "gflops": gflops(out)}
            row.update(score(host_disp(out), dense_disp))
            cells.append((row, fn))

        named = {str(i): fn for i, (_, fn) in enumerate(cells)}
        timed = measure(named, {k: max(1, k1) for k in named}, 3, dev,
                        warmup=k0)
        for i, (row, _) in enumerate(cells):
            t = timed[str(i)]
            ms = t["ms"]
            row["ms_per_image"] = ms / args.batch if ms is not None else None
            row["ms_windows"] = t["windows"]
            if ms is None:
                row["latency_unreliable"] = True
            rows.append(row)
            label = (row["mask_family"] if row["threshold"] is None
                     else f"{row['mask_family']}@{row['threshold']:.3f}")
            print(f"[{src}] {label}: density={row['density']:.4f} "
                  f"{row['gflops']:.2f} GF "
                  + (f"{row['ms_per_image']:.3f} ms/img"
                     if ms is not None else "latency unreliable")
                  + f" mae={row['disp_mae_vs_dense']:.5f}")

    info = device_info(dev)
    result = {
        "meta": {
            "model": model_name,
            "shape": [args.batch, args.height, args.width],
            "dtype": "bfloat16" if args.bfloat16 else "float32",
            "device": (f"{info['name']}, {info['power_limit']}"
                       if info["power_limit"] else info["name"]),
            "device_name": info["name"],
            "power_limit": info["power_limit"],
            "measurement": ("CUDA events" if dev.type == "cuda"
                            else "host clock")
                           + f": median of 3 interleaved windows of {k1} "
                             f"calls after {k0} warm-ups (K={k0}->{k1}); "
                             "a row whose windows spread > 10% after two "
                             "re-measurements is null",
            "inputs": (args.image or
                       "maskgen synthetic scenes (GT disparity axis)"),
            "train_steps": (args.train_steps
                            if "synthetic" in sources else 0),
        },
        "rows": rows,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
