"""FLOP accounting and a trace of one forward of the KITTI model.

Counterpart of `wavelet_monodepth_tpu/tools/profile_model.py` (the
reference's analytic op counters, `depth_decoder.py:246-266,299-427`,
and thop/ptflops in its notebooks). For ResNet --num_layers + the KITTI
wavelet decoder at --height x --width, batch 1, seeded fan-in weights
and a seeded uniform image, it reports:

  * "torch_flop_counter": `torch.utils.flop_counter.FlopCounterMode`
    over the dense forward: total FLOPs and FLOPs per ATen op. It counts
    convolutions and matrix products only (no BN, padding or elementwise
    work), where the JAX package reports XLA's `cost_analysis` of the
    compiled forward under "xla_cost_analysis"; the two differ by what
    they count and are not compared;
  * "analytic_sweep": the decoder's own `total_ops` (GFLOPs) and the
    coefficient density at each of --thresholds, as JAX's;
  * with --trace_dir, a torch.profiler Chrome trace of one dense forward
    (`trace.json` there), and its path under "trace".

Runs on --device (cuda, which raises without a card, or cpu).

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.profile_model \\
      [--height 192 --width 640 --num_layers 18] [--trace_dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="profile_model")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--num_layers", type=int, default=18)
    p.add_argument("--thresholds", nargs="+", type=float,
                   default=[-1, 0.05, 0.1])
    p.add_argument("--trace_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def analytic_sweep(encoder, decoder, x, thresholds) -> list:
    """[{"threshold", "decoder_gflops", "density"}] of the sparse decoder
    at each threshold (batch means)."""
    import torch
    from ..ops.sparse import compute_density
    rows = []
    with torch.inference_mode():
        feats = encoder(x)
        for th in thresholds:
            out = decoder(feats, thresh_ratio=float(th))
            rows.append({
                "threshold": th,
                "decoder_gflops":
                    float(out[("total_ops", -1)].float().mean()) / 1e9,
                "density": float(compute_density(out))})
    return rows


def main(argv=None, device=None) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.decoders_kitti import KittiWaveletDecoder
    from ..models.layers import init_params
    from ..models.resnet import ResnetEncoder
    from ..utils import device as device_rule

    args = parse_args(argv)
    dev = device_rule.resolve_device(device if device is not None
                                     else args.device)
    device_rule.pin_float32(dev)
    gen = torch.Generator().manual_seed(0)
    encoder = init_params(ResnetEncoder(args.num_layers), gen).to(dev).eval()
    decoder = init_params(KittiWaveletDecoder(encoder.num_ch_enc),
                          gen).to(dev).eval()
    x = torch.rand(1, args.height, args.width, 3, generator=gen).to(dev)

    def dense():
        with torch.inference_mode():
            return decoder(encoder(x))[("disp", 0)]

    counter = FlopCounterMode(display=False)
    with counter:
        dense()
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    report = {
        "torch_flop_counter": {"flops": int(counter.get_total_flops()),
                               "by_op": by_op},
        "analytic_sweep": analytic_sweep(encoder, decoder, x,
                                         args.thresholds),
    }
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        dense()                              # warm-up outside the trace
        with profile(activities=activities) as prof:
            dense()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        os.makedirs(args.trace_dir, exist_ok=True)
        report["trace"] = os.path.join(args.trace_dir, "trace.json")
        prof.export_chrome_trace(report["trace"])
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
