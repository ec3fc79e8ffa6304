"""Pretrained-checkpoint helper: the `KITTI/utils.py:51-114` equivalent
(monodepth2-style model downloader), adapted for offline environments.

Counterpart of `wavelet_monodepth_tpu/tools/fetch_pretrained.py`, with
its flags, `KNOWN_MODELS` and report dict. It downloads nothing: it (a)
lists where the published checkpoints live, (b) verifies a local folder
has the files the evaluators need, and (c) loads them through the port's
importer into the port's modules with `strict=True`. A KITTI folder's
ResNet depth comes from the block counts of encoder.pth
(`golden_check.resnet_layers_of`), so a ResNet50 folder is read as one
(JAX's test for a second layer1 block calls every bottleneck ResNet a
resnet18; ROADMAP queue 3). It runs on the CPU.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.fetch_pretrained \\
      --check weights/
"""

from __future__ import annotations

import argparse
import os

# Published WaveletMonoDepth checkpoints (reference README.md:85-95,
# 134-141) and the torchvision ImageNet backbones the trainer
# initializes from.
KNOWN_MODELS = {
    "kitti_resnet18_640x192": "WaveletMonoDepth release: "
                              "ResNet18, Stereo+DepthHints, 640x192",
    "kitti_resnet50_640x192": "WaveletMonoDepth release: ResNet50 640x192",
    "kitti_resnet18_1024x320": "WaveletMonoDepth release: "
                               "ResNet18 1024x320",
    "kitti_resnet50_1024x320": "WaveletMonoDepth release: "
                               "ResNet50 1024x320",
    "nyu_densenet": "WaveletMonoDepth release: DenseNet161 NYUv2",
    "imagenet_resnet18": "torchvision resnet18 ImageNet weights",
    "imagenet_resnet50": "torchvision resnet50 ImageNet weights",
    "imagenet_densenet161": "torchvision densenet161 ImageNet weights",
    "imagenet_mobilenet_v2": "torchvision mobilenet_v2 ImageNet weights",
}

KITTI_FILES = ("encoder.pth", "depth.pth")
NYU_FILES = ("model.pth",)


def _load_kitti(path: str, report: dict) -> None:
    from ..models.decoders_kitti import KittiWaveletDecoder
    from ..models.resnet import ResnetEncoder
    from . import torch_import as ti
    from .golden_check import resnet_layers_of

    enc_sd, dec_sd = ti.load_reference_checkpoint(path)
    meta = {k: int(enc_sd[k]) for k in ("height", "width", "use_stereo")
            if k in enc_sd}
    report["details"].append(f"encoder meta: {meta}")
    num_layers = resnet_layers_of(enc_sd, "encoder.")
    if num_layers is None:
        report["details"].append("encoder.pth keys do not look like a "
                                 "torchvision resnet under 'encoder.'")
        return
    encoder = ResnetEncoder(num_layers=num_layers)
    decoder = KittiWaveletDecoder(num_ch_enc=encoder.num_ch_enc)
    ti.load_state_dicts(encoder, decoder, enc_sd, dec_sd)
    report["ok"] = True
    report["details"].append(
        f"imported as resnet{num_layers} + wavelet decoder")


def _load_nyu(path: str, report: dict) -> None:
    from ..models.decoders_nyu import NyuDecoderWave
    from ..models.densenet import NUM_CH_ENC, DenseNet161Encoder
    from . import torch_import as ti

    enc_sd, dec_sd = ti.load_nyu_model_pth(os.path.join(path, "model.pth"))
    ti.load_state_dicts(DenseNet161Encoder(normalize_input=False),
                        NyuDecoderWave(num_ch_enc=NUM_CH_ENC,
                                       decoder_width=0.5), enc_sd, dec_sd)
    report["ok"] = True
    report["details"].append("imported DenseNet161 + DecoderWave")


def check_folder(path: str) -> dict:
    """Verify a weights folder and load it strictly into the port's
    modules. Returns {"path", "kind", "ok", "details"}."""
    report = {"path": path, "kind": None, "ok": False, "details": []}
    if all(os.path.exists(os.path.join(path, f)) for f in KITTI_FILES):
        report["kind"], load = "kitti", _load_kitti
    elif all(os.path.exists(os.path.join(path, f)) for f in NYU_FILES):
        report["kind"], load = "nyu", _load_nyu
    else:
        report["details"].append(
            f"no {KITTI_FILES} or {NYU_FILES} found")
        return report
    try:
        load(path, report)
    except RuntimeError as e:        # load_state_dict(strict=True)
        report["details"].append(
            f"import failed: {' '.join(str(e).split())}")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="fetch_pretrained")
    p.add_argument("--check", type=str, default=None,
                   help="verify a local weights folder")
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)
    if args.list or not args.check:
        print("Known model checkpoints (download on a connected machine "
              "from the WaveletMonoDepth / torchvision releases):")
        for k, v in KNOWN_MODELS.items():
            print(f"  {k:28s} {v}")
        return
    report = check_folder(args.check)
    print(report)
    raise SystemExit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
