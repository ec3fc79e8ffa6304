"""NYUv2 evaluation CLI: the port's `NYUv2/evaluate.py:19-107`.

Counterpart of `wavelet_monodepth_tpu/tools/evaluate_nyu.py`, with its
flags plus --device. Loads nyu_depth_v2_labeled.mat + splits.mat (the
654 official test images), optional NYUv2-OC++ edge GT PNGs, runs the
model (dense, or sparse with --use_sparse --threshold T on the decoder's
default masked-dense backend, as in the JAX package) and prints abs_rel /
rmse / log10 / deltas (+ eps_acc / eps_comp with edges); `main` returns
the row as a dict.

Weights: --torch_model_path, a reference `model.pth` of the DenseNet161
+ DecoderWave family (`encoder.original_model.features.*`, `decoder.*`);
without it, the seeded fresh init (seed 0). --load_weights_folder names
the JAX package's flax checkpoint, which the port cannot read; the NYU
training slice brings the port's own checkpoint layout. --bfloat16 casts
the model whole (`utils/precision.py`); outputs come back float32.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.evaluate_nyu \
      --data_path nyu_depth_v2_labeled.mat --splits_path splits.mat \
      --torch_model_path model.pth --use_wavelets [--edges_dir nyu_oc] \
      [--use_sparse --threshold 0.05] [--bfloat16] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def adopt_normalize_input(load_weights_folder, cli_flag: bool) -> bool:
    """A checkpoint trained with normalize_input=True (real ImageNet
    normalisation; the reference's flag is a silent no-op) is evaluated
    the way it was trained: its run's opt.json, beside the weights_<epoch>
    folders, decides unless the CLI already asked for normalisation."""
    if cli_flag or not load_weights_folder:
        return cli_flag
    opt_json = os.path.join(
        os.path.dirname(os.path.abspath(load_weights_folder)), "opt.json")
    if os.path.exists(opt_json):
        import json
        with open(opt_json) as f:
            saved = json.load(f)
        if saved.get("normalize_input"):
            print("adopting normalize_input=True from the checkpoint's "
                  f"{opt_json}")
            return True
    return cli_flag


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="evaluate_nyu (PyTorch port)")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--splits_path", type=str, required=True)
    p.add_argument("--edges_dir", type=str, default=None)
    p.add_argument("--load_weights_folder", type=str, default=None)
    p.add_argument("--torch_model_path", type=str, default=None,
                   help="reference model.pth (encoder.*/decoder.* "
                        "scopes, `NYUv2/load_save_utils.py`)")
    p.add_argument("--encoder_type", type=str, default="densenet")
    p.add_argument("--num_layers", type=int, default=161)
    p.add_argument("--use_wavelets", action="store_true")
    p.add_argument("--use_sparse", action="store_true")
    p.add_argument("--use_224", action="store_true")
    p.add_argument("--disparity", action="store_true")
    p.add_argument("--threshold", type=float, default=-1)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--save_wavelets_dir", type=str, default=None)
    p.add_argument("--bfloat16", action="store_true",
                   help="run the model in bfloat16 (outputs f32)")
    p.add_argument("--normalize_input", action="store_true",
                   help="real ImageNet input normalization (the "
                        "reference's flag is a silent no-op). Adopted "
                        "from the checkpoint's opt.json when present")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without a card) or cpu")
    return p.parse_args(argv)


def nyu_options(args):
    from ..utils.config import NyuOptions
    return NyuOptions(
        encoder_type=args.encoder_type, num_layers=args.num_layers,
        use_wavelets=args.use_wavelets, use_sparse=args.use_sparse,
        use_224=args.use_224, disparity=args.disparity,
        normalize_input=adopt_normalize_input(args.load_weights_folder,
                                              args.normalize_input),
        bfloat16=args.bfloat16, load_weights_folder=args.load_weights_folder,
        device=args.device)


def load_forward(opts, device, torch_model_path=None, use_pallas=False,
                 capacity_ratio: float = 0.5):
    """The model's forward on `device`, in eval mode, from
    `torch_model_path` (a reference model.pth) or the seeded fresh init.
    forward(image (N, H, W, 3) float in [0, 1] on `device`, thresh or
    None, mask_override=None) -> the decoder's output dict, float32 also
    under --bfloat16; with a thresh (and use_wavelets + use_sparse) the
    sparse decoder runs on `use_pallas` (the JAX CLI's masked dense by
    default), its masks replaced by `mask_override` where given."""
    from ..models.factory import make_nyu_decoder, make_nyu_encoder
    from ..models.layers import init_params
    from ..utils.precision import cast_floats, wrap_forward_bf16
    from . import torch_import as ti

    if opts.load_weights_folder:
        raise NotImplementedError(
            "--load_weights_folder names the JAX package's flax msgpack "
            "checkpoint, which the port cannot read; the NYU training "
            "slice brings the port's own NYU checkpoint layout (ROADMAP.md, "
            "Queue 1 item 4). Export it with the JAX package's "
            "tools/export_torch.py and pass --torch_model_path")
    encoder, num_ch_enc = make_nyu_encoder(opts)
    decoder = make_nyu_decoder(num_ch_enc, opts)
    if torch_model_path:
        if opts.encoder_type != "densenet":
            raise SystemExit("--torch_model_path import currently "
                             "supports the densenet161 family")
        if not opts.use_wavelets:
            raise SystemExit("--torch_model_path import currently "
                             "supports the DecoderWave family "
                             "(--use_wavelets)")
        ti.load_state_dicts(encoder, decoder,
                            *ti.load_nyu_model_pth(torch_model_path))
    else:
        gen = torch.Generator().manual_seed(0)
        init_params(encoder, gen)
        init_params(decoder, gen)
    encoder.to(device).eval()
    decoder.to(device).eval()
    if opts.bfloat16:
        cast_floats(encoder, torch.bfloat16)
        cast_floats(decoder, torch.bfloat16)
    sparse = opts.use_wavelets and opts.use_sparse

    @torch.inference_mode()
    def forward(image: torch.Tensor, thresh=None, mask_override=None):
        feats = encoder(image)
        if thresh is not None and sparse:
            return decoder(feats, thresh_ratio=thresh, use_pallas=use_pallas,
                           capacity_ratio=capacity_ratio,
                           mask_override=mask_override)
        return decoder(feats)

    return wrap_forward_bf16(forward) if opts.bfloat16 else forward


def load_edges(edges_dir: str, n: int) -> np.ndarray:
    """NYUv2-OC++ edge GT: 0001.png .. n.png, > 0 is an edge."""
    from PIL import Image
    return np.stack([np.array(Image.open(os.path.join(
        edges_dir, f"{i:04d}.png"))) > 0 for i in range(1, n + 1)])


def main(argv=None):
    from ..eval import nyu_eval
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":       # float32 means float32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    opts = nyu_options(args)
    forward = load_forward(opts, device, args.torch_model_path)

    rgb, depth = nyu_eval.load_nyu_labeled(args.data_path, args.splits_path)
    if args.max_images:
        rgb, depth = rgb[:args.max_images], depth[:args.max_images]
    edges = load_edges(args.edges_dir, rgb.shape[0]) if args.edges_dir \
        else None

    thresh = args.threshold if args.use_sparse else None
    result = nyu_eval.evaluate(forward, rgb, depth, edges_gt=edges,
                               use_disparity=args.disparity,
                               use_224=args.use_224,
                               sparse_threshold=thresh,
                               save_wavelets_dir=args.save_wavelets_dir,
                               device=device)
    keys = ["abs_rel", "rmse", "log10", "a1", "a2", "a3"]
    if "eps_acc" in result:
        keys += ["eps_acc", "eps_comp"]
    print(("{:>10} " * len(keys)).format(*keys))
    print(("{:10.4f} " * len(keys)).format(*[result[k] for k in keys]))
    return result


if __name__ == "__main__":
    main()
