"""Export the depth network as a `torch.export` serving artifact.

Counterpart of `wavelet_monodepth_tpu/tools/export_serving.py`, with its
flags plus --device. The forward (dense, or the masked-sparse decode at a
fixed threshold; float32 or the full bfloat16 cast of `--bfloat16`) is
exported with `torch.export.export` to an `ExportedProgram` that a server
loads and runs without the model-building Python
(`tools/serve_artifact.py`). The decoder runs its default sparse backend,
the masked-dense one, as JAX's exporter does: no kernel of the repo lies
on this path.

Parameters and buffers are not part of the contract: the server loads a
state dict into the program's module with `strict=True`, so one artifact
serves every checkpoint of one architecture, as JAX's artifact takes its
variables as runtime inputs. Shapes are static (batch, height and width
fixed at export).

The program is exported on the device that will serve it (--device,
cuda by default, which raises without a card): the graph records the
device of its constants, so an artifact exported on the CPU is not a
card artifact. TF32 is a process flag that the artifact does not carry;
both this tool and the server turn it off (`utils/device.pin_float32`).

Writes:
  <out>.pt2        the exported program (`torch.export.save`)
  <out>.json       metadata: shapes, dtypes, threshold, outputs, and
                   `platforms` = [device type, the device's name]
  <out>.params.pt  (--bundle_params) the state dict the program takes,
                   under the port's names: `encoder.*` and `depth.*`
                   (KITTI, the trainer's scopes) or `decoder.*` (NYU,
                   the reference model.pth's)

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.export_serving \\
      --out /tmp/r18_640x192 [--torch_model_path folder] [--batch 1] \\
      [--use_sparse --threshold 0.1] [--bfloat16] [--uint8_input] \\
      [--bundle_params] [--verify] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.nn as nn


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export the depth net as a torch.export artifact")
    p.add_argument("--out", type=str, required=True,
                   help="output path prefix (writes .pt2 + .json)")
    p.add_argument("--model_path", type=str, default=None,
                   help="kitti: the port's checkpoint folder (encoder.pth "
                        "+ depth.pth); nyu: a weights_<epoch> folder of "
                        "tools/train_nyu.py (default: the seeded fresh "
                        "init, for artifact testing)")
    p.add_argument("--torch_model_path", type=str, default=None,
                   help="kitti: a reference folder (encoder.pth + "
                        "depth.pth); nyu: a reference DenseNet161 "
                        "DecoderWave model.pth")
    p.add_argument("--family", choices=["kitti", "nyu"], default="kitti",
                   help="kitti = ResNet + wavelet decoder; nyu = "
                        "DenseNet161/etc + NYU wavelet decoder")
    p.add_argument("--encoder_type", type=str, default="densenet",
                   help="nyu family encoder (densenet/resnet/"
                        "mobilenet/mobilenet_light)")
    p.add_argument("--num_layers", type=int, default=18)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--use_sparse", action="store_true",
                   help="export the masked-sparse decode at --threshold")
    p.add_argument("--threshold", type=float, default=0.1)
    p.add_argument("--bfloat16", action="store_true")
    p.add_argument("--uint8_input", action="store_true",
                   help="artifact takes uint8 [0,255] images and casts "
                        "to float inside the program")
    p.add_argument("--verify", action="store_true",
                   help="load the artifact, run it and check its output "
                        "is finite")
    p.add_argument("--bundle_params", action="store_true",
                   help="also write <out>.params.pt, the state dict "
                        "tools/serve_artifact.py loads into the program")
    p.add_argument("--device", type=str, default="cuda",
                   help="the serving device: cuda (the default; raises "
                        "without a card) or cpu")
    return p.parse_args(argv)


class ServingProgram(nn.Module):
    """What the artifact computes: image (N, H, W, 3) -> disp at scale 0
    as float32 (N, H, W, 1), and with a threshold also the decoder's
    ("total_ops", -1) (N,). A uint8 image is scaled by 1/255 inside; under
    bfloat16 the image is cast to bfloat16 (the modules already are)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 decoder_scope: str, thresh=None, uint8_input: bool = False,
                 bfloat16: bool = False):
        super().__init__()
        self.encoder = encoder
        self.add_module(decoder_scope, decoder)
        self.decoder_scope = decoder_scope
        self.thresh = thresh
        self.uint8_input = uint8_input
        self.bfloat16 = bfloat16

    def forward(self, image: torch.Tensor):
        if self.uint8_input:
            # the cast of the uint8 train feed (ops/augment.py)
            image = image.to(torch.float32) / 255.0
        if self.bfloat16:
            image = image.to(torch.bfloat16)
        decoder = getattr(self, self.decoder_scope)
        feats = self.encoder(image)
        if self.thresh is None:
            return decoder(feats)[("disp", 0)].float()
        out = decoder(feats, thresh_ratio=self.thresh)
        return out[("disp", 0)].float(), out[("total_ops", -1)]


def _kitti_modules(args):
    """(encoder, decoder) of the kitti family, from --torch_model_path or
    --model_path (both encoder.pth + depth.pth folders) or seeded."""
    from ..models.decoders_kitti import KittiWaveletDecoder
    from ..models.layers import init_params
    from ..models.resnet import ResnetEncoder
    from . import torch_import as ti

    encoder = ResnetEncoder(num_layers=args.num_layers)
    decoder = KittiWaveletDecoder(num_ch_enc=encoder.num_ch_enc)
    folder = args.torch_model_path or args.model_path
    if folder:
        report = ti.load_state_dicts(encoder, decoder,
                                     *ti.load_reference_checkpoint(folder))
        fh = report["meta"].get("height", args.height)
        fw = report["meta"].get("width", args.width)
        if (fh, fw) != (args.height, args.width):
            print(f"note: checkpoint feed size {fh}x{fw}; exporting at "
                  f"requested {args.height}x{args.width}")
    else:
        gen = torch.Generator().manual_seed(0)
        init_params(encoder, gen)
        init_params(decoder, gen)
    return encoder, decoder


def _nyu_modules(args):
    """(encoder, decoder) of the nyu family: --torch_model_path (a
    reference model.pth, densenet only, as JAX), --model_path (a
    weights_<epoch> folder of the port's NYU trainer) or seeded."""
    from ..models.factory import make_nyu_decoder, make_nyu_encoder
    from ..models.layers import init_params
    from ..utils.config import NyuOptions
    from . import torch_import as ti

    opts = NyuOptions(encoder_type=args.encoder_type,
                      num_layers=args.num_layers, use_wavelets=True,
                      use_sparse=args.use_sparse)
    encoder, nch = make_nyu_encoder(opts)
    decoder = make_nyu_decoder(nch, opts)
    if args.torch_model_path:
        if args.encoder_type != "densenet":
            raise SystemExit(
                "--torch_model_path for the nyu family supports "
                "--encoder_type densenet (the published checkpoints; no "
                f"importer mapping for {args.encoder_type})")
        path = args.torch_model_path
    elif args.model_path:
        path = os.path.join(args.model_path, "model.pth")
    else:
        gen = torch.Generator().manual_seed(0)
        init_params(encoder, gen)
        init_params(decoder, gen)
        return encoder, decoder
    ti.load_state_dicts(encoder, decoder, *ti.load_nyu_model_pth(path))
    return encoder, decoder


def build(args, device) -> ServingProgram:
    """The program to export, in eval mode on `device`; its state dict is
    what the artifact takes."""
    from ..utils.precision import cast_floats

    nyu = getattr(args, "family", "kitti") == "nyu"
    encoder, decoder = (_nyu_modules if nyu else _kitti_modules)(args)
    if args.bfloat16:
        cast_floats(encoder, torch.bfloat16)
        cast_floats(decoder, torch.bfloat16)
    program = ServingProgram(
        encoder, decoder, "decoder" if nyu else "depth",
        thresh=args.threshold if args.use_sparse else None,
        uint8_input=getattr(args, "uint8_input", False),
        bfloat16=args.bfloat16)
    return program.to(device).eval()


def export_artifact(args, device):
    """Export build(args, device) to args.out + .pt2 / .json (and
    .params.pt with --bundle_params). Returns (the ExportedProgram, the
    program module)."""
    program = build(args, device)
    u8 = getattr(args, "uint8_input", False)
    example = torch.zeros((args.batch, args.height, args.width, 3),
                          dtype=torch.uint8 if u8 else torch.float32,
                          device=device)
    with torch.no_grad():
        exported = torch.export.export(program, (example,))
    torch.export.save(exported, args.out + ".pt2")

    fam = getattr(args, "family", "kitti")
    meta = {
        "model": (f"kitti_r{args.num_layers}_wavelet" if fam == "kitti"
                  else f"nyu_{args.encoder_type}_wavelet"),
        "batch": args.batch, "height": args.height, "width": args.width,
        "dtype": "bfloat16" if args.bfloat16 else "float32",
        "input_dtype": "uint8" if u8 else "float32",
        "sparse_threshold": args.threshold if args.use_sparse else None,
        "platforms": [device.type, torch.cuda.get_device_name(device)
                      if device.type == "cuda" else device.type],
        "outputs": (["disp_0", "total_ops"] if args.use_sparse
                    else ["disp_0"]),
        "calling_convention": "torch.export.load(<out>.pt2).module(), "
                              "load_state_dict(<out>.params.pt, "
                              "strict=True), then call it on the image "
                              "(N, H, W, 3) on the platform's device",
        "torch": torch.__version__,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    if getattr(args, "bundle_params", False):
        torch.save({k: v.detach().cpu()
                    for k, v in program.state_dict().items()},
                   args.out + ".params.pt")
    size = os.path.getsize(args.out + ".pt2")
    print(f"exported {size} bytes -> {args.out}.pt2 "
          f"(platforms {meta['platforms']})")
    return exported, program


def verify_artifact(path_prefix, state: dict, args, device) -> None:
    """Load the artifact with `state`, run it on a seeded random image and
    check the disparity is finite (the tests hold it to the direct
    forward)."""
    from .serve_artifact import load_program

    program, _ = load_program(path_prefix, device, state)
    gen = torch.Generator().manual_seed(1)
    shape = (args.batch, args.height, args.width, 3)
    if getattr(args, "uint8_input", False):
        img = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    else:
        img = torch.rand(shape, generator=gen)
    with torch.inference_mode():
        out = program(img.to(device))
    disp = out[0] if isinstance(out, (tuple, list)) else out
    if not bool(torch.isfinite(disp).all()):
        raise RuntimeError("artifact produced non-finite disp")
    print(f"verified: artifact runs, disp range "
          f"[{float(disp.min()):.4f}, {float(disp.max()):.4f}]")


def main(argv=None, device=None):
    """Exports on `device`, else on --device; returns (the ExportedProgram,
    the program module)."""
    from ..utils import device as device_rule

    args = parse_args(argv)
    device = device_rule.resolve_device(device if device is not None
                                        else args.device)
    device_rule.pin_float32(device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    exported, program = export_artifact(args, device)
    if args.verify:
        verify_artifact(args.out, program.state_dict(), args, device)
    return exported, program


if __name__ == "__main__":
    main()
