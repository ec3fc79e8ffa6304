"""Single-image inference: the serving entry point of the port.

Counterpart of `wavelet_monodepth_tpu/tools/infer.py`, with the same
flags and outputs. Loads a reference checkpoint folder
(--torch_model_path: encoder.pth with the height/width/use_stereo ints,
depth.pth), reads the feed size from it, runs dense or sparse wavelet
decoding, and writes <name>_disp.npy (scaled disparity, NCHW),
<name>_scale_<s>_wavelets.npy (LL, LH, HL, HH per scale) and a
magma-coloured <name>_disp.jpeg with a 95th-percentile vmax.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.infer --image_path img.png \
      --torch_model_path weights_folder [--use_sparse --threshold 0.1] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

# magma sampled at 17 evenly spaced points (matplotlib's table), linearly
# interpolated: within 2.3/255 of matplotlib's 256-entry map, without
# needing matplotlib at run time
_MAGMA = np.array([
    (0.0015, 0.0005, 0.0139), (0.0396, 0.0311, 0.1335),
    (0.1131, 0.0655, 0.2768), (0.2117, 0.0620, 0.4186),
    (0.3167, 0.0717, 0.4854), (0.4147, 0.1104, 0.5047),
    (0.5128, 0.1482, 0.5076), (0.6136, 0.1818, 0.4985),
    (0.7164, 0.2150, 0.4753), (0.8169, 0.2559, 0.4365),
    (0.9043, 0.3196, 0.3881), (0.9609, 0.4183, 0.3596),
    (0.9867, 0.5356, 0.3822), (0.9961, 0.6537, 0.4462),
    (0.9969, 0.7696, 0.5349), (0.9924, 0.8843, 0.6401),
    (0.9871, 0.9914, 0.7495)])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Single-image depth inference")
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="folder with state.msgpack + meta.json (the JAX "
                        "package's format; not readable by the port)")
    p.add_argument("--torch_model_path", type=str, default=None,
                   help="folder with reference encoder.pth/depth.pth")
    p.add_argument("--encoder_type", choices=["resnet"], default="resnet")
    p.add_argument("--num_layers", type=int, choices=[18, 50], default=18)
    p.add_argument("--ext", type=str, default="png")
    p.add_argument("--use_wavelets", action="store_true", default=True)
    p.add_argument("--use_sparse", action="store_true")
    p.add_argument("--threshold", type=float, default=0.1)
    p.add_argument("--bfloat16", action="store_true",
                   help="run the model in bfloat16 (not ported yet)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def load_model(args, device, use_pallas=False):
    """Build the encoder and decoder from --torch_model_path on `device`.
    Returns (forward, (feed_h, feed_w)); forward(image (N, H, W, 3) float
    tensor on `device`, thresh or None) -> the decoder's output dict.
    `use_pallas` is the decoder's sparse backend (False/"xla", True /
    "pallas", "pallas2d")."""
    from ..models.decoders_kitti import KittiWaveletDecoder
    from ..models.resnet import ResnetEncoder
    from . import torch_import as ti

    if args.model_path and not args.torch_model_path:
        raise SystemExit(
            "--model_path is the JAX package's msgpack checkpoint, which "
            "needs flax to read; export it to a reference folder with "
            "`python -m wavelet_monodepth_tpu.tools.export_torch` and pass "
            "that as --torch_model_path")
    if not args.torch_model_path:
        raise SystemExit("pass --torch_model_path (folder with the "
                         "reference's encoder.pth/depth.pth)")
    if getattr(args, "bfloat16", False):
        raise NotImplementedError("--bfloat16 is not ported yet (ROADMAP.md, "
                                  "follow-ups of the inference slice: bf16)")

    encoder = ResnetEncoder(num_layers=args.num_layers)
    decoder = KittiWaveletDecoder(num_ch_enc=encoder.num_ch_enc)
    enc_sd, dec_sd = ti.load_reference_checkpoint(args.torch_model_path)
    report = ti.load_state_dicts(encoder, decoder, enc_sd, dec_sd)
    if report["dropped"] or report["filled"]:
        print(f"-> checkpoint: dropped {report['dropped']} (nothing in the "
              f"port holds them), filled {len(report['filled'])} BatchNorm "
              "num_batches_tracked buffers")
    feed_h = report["meta"].get("height", 192)
    feed_w = report["meta"].get("width", 640)
    encoder.to(device).eval()
    decoder.to(device).eval()

    @torch.inference_mode()
    def forward(image: torch.Tensor, thresh):
        feats = encoder(image)
        if thresh is None:
            return decoder(feats)
        return decoder(feats, thresh_ratio=thresh, use_pallas=use_pallas)

    return forward, (feed_h, feed_w)


def preprocess_image(path: str, feed_w: int, feed_h: int):
    """RGB image file -> ((1, feed_h, feed_w, 3) float32 in [0, 1],
    (orig_w, orig_h)), resized with Lanczos as the reference does."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    size = img.size
    img = img.resize((feed_w, feed_h), Image.LANCZOS)
    return (np.asarray(img, np.float32) / 255.0)[None], size


def colormap_disp(disp: np.ndarray) -> np.ndarray:
    """(H, W) -> (H, W, 3) uint8 magma, vmin = min, vmax = 95th pct."""
    vmin, vmax = float(disp.min()), float(np.percentile(disp, 95))
    t = np.clip((disp - vmin) / max(vmax - vmin, 1e-12), 0.0, 1.0)
    pos = np.linspace(0.0, 1.0, len(_MAGMA))
    rgb = np.stack([np.interp(t, pos, _MAGMA[:, c]) for c in range(3)], -1)
    return (rgb * 255).astype(np.uint8)


def main(argv=None, device=None):
    """Runs on `device`, else on --device (cuda by default, which raises
    without a card)."""
    from PIL import Image
    from ..ops.geometry import disp_to_depth
    from ..ops.image import resize_bilinear
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    forward, (feed_h, feed_w) = load_model(args, device)

    if os.path.isfile(args.image_path):
        paths = [args.image_path]
        outdir = os.path.dirname(args.image_path)
    elif os.path.isdir(args.image_path):
        paths = sorted(glob.glob(os.path.join(args.image_path,
                                              f"*.{args.ext}")))
        outdir = args.image_path
    else:
        raise FileNotFoundError(args.image_path)

    print(f"-> Predicting on {len(paths)} test images")
    for idx, path in enumerate(paths):
        if path.endswith(("_disp.jpg", "_disp.jpeg")):
            continue
        x, (ow, oh) = preprocess_image(path, feed_w, feed_h)
        thresh = args.threshold if args.use_sparse else None
        outputs = forward(torch.from_numpy(x).to(device), thresh)
        disp = outputs[("disp", 0)]
        disp_resized = resize_bilinear(disp, oh, ow)

        name = os.path.splitext(os.path.basename(path))[0]
        scaled_disp, _ = disp_to_depth(disp, 0.1, 100)
        np.save(os.path.join(outdir, f"{name}_disp.npy"),
                scaled_disp.permute(0, 3, 1, 2).cpu().numpy())

        if args.use_wavelets:
            for scale in range(4):
                coeffs = torch.cat(
                    [outputs[("wavelets", scale, c)][0]
                     for c in ("LL", "LH", "HL", "HH")], dim=-1)
                np.save(os.path.join(outdir,
                                     f"{name}_scale_{scale}_wavelets.npy"),
                        coeffs.float().cpu().numpy())

        im = Image.fromarray(colormap_disp(
            disp_resized[0, :, :, 0].float().cpu().numpy()))
        im.save(os.path.join(outdir, f"{name}_disp.jpeg"))
        print(f"   Processed {idx + 1} of {len(paths)} images")
    print("-> Done!")


if __name__ == "__main__":
    main()
