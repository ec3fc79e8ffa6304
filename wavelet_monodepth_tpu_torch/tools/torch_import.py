"""Weight bridge: JAX variable trees and reference checkpoints to the
port's modules.

Counterpart of the export half of
`wavelet_monodepth_tpu/tools/torch_import.py:361-426`
(`export_resnet_encoder`, `export_kitti_wavelet_decoder`), written again
here so the port imports nothing of the JAX package. The port's modules
carry the reference's state-dict names, so:

  * `state_dicts_from_jax(enc_vars, dec_vars)` turns JAX variables
    (nested dicts of numpy arrays) into the reference-named encoder and
    decoder state dicts, key for key what the JAX exporter writes, and
    `param_trees_from_jax` does the same for parameter-shaped trees (a
    gradient, updated parameters) without BN statistics;
  * `load_reference_checkpoint(folder)` reads a reference
    `encoder.pth` / `depth.pth` pair, and `save_reference_checkpoint`
    writes one;
  * `load_state_dicts(encoder, decoder, enc_sd, dec_sd)` loads either
    with `strict=True` after two reported fix-ups: it drops what the port
    has no module for (torchvision's `encoder.fc.*` classifier and the
    `height` / `width` / `use_stereo` ints, returned as metadata) and
    fills in BatchNorm's `num_batches_tracked`, which the JAX exporter
    never writes and eval mode never reads.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

_META_KEYS = ("height", "width", "use_stereo")


def _conv_w(v) -> torch.Tensor:
    """HWIO -> OIHW."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(v, np.float32), (3, 2, 0, 1))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def _take_bn(sd: dict, tprefix: str, params: dict, stats):
    sd[f"{tprefix}.weight"] = _vec(params["scale"])
    sd[f"{tprefix}.bias"] = _vec(params["bias"])
    if stats is not None:
        sd[f"{tprefix}.running_mean"] = _vec(stats["mean"])
        sd[f"{tprefix}.running_var"] = _vec(stats["var"])


def _sub(tree, *keys):
    """tree[k0][k1]..., or None when tree is None."""
    for k in keys:
        if tree is None:
            return None
        tree = tree[k]
    return tree


def _encoder_state(variables: dict) -> dict:
    """ResNet encoder variables {params, batch_stats} of any depth ->
    torchvision names under the reference's `encoder.` scope (parameters
    only when there are no batch_stats): conv1..conv2 (BasicBlock) or
    conv1..conv3 (Bottleneck) per block, then its downsample."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    sd: dict = {}
    sd["encoder.conv1.weight"] = _conv_w(params["stem"]["conv"]["kernel"])
    _take_bn(sd, "encoder.bn1", params["stem"]["bn"],
             _sub(stats, "stem", "bn"))
    for li in range(1, 5):
        b = 0
        while f"layer{li}_{b}" in params:
            t = f"encoder.layer{li}.{b}."
            name = f"layer{li}_{b}"
            k = 1
            while f"conv{k}" in params[name]:
                node = params[name][f"conv{k}"]
                sd[f"{t}conv{k}.weight"] = _conv_w(node["conv"]["kernel"])
                _take_bn(sd, f"{t}bn{k}", node["bn"],
                         _sub(stats, name, f"conv{k}", "bn"))
                k += 1
            if "downsample" in params[name]:
                node = params[name]["downsample"]
                sd[f"{t}downsample.0.weight"] = _conv_w(
                    node["conv"]["kernel"])
                _take_bn(sd, f"{t}downsample.1", node["bn"],
                         _sub(stats, name, "downsample", "bn"))
            b += 1
    return sd


def _conv_to(sd: dict, t: str, node: dict):
    sd[f"{t}.weight"] = _conv_w(node["kernel"])
    sd[f"{t}.bias"] = _vec(node["bias"])


def _decoder_state(variables: dict) -> dict:
    """KittiWaveletDecoder params -> the reference's `decoder.<idx>.`
    ModuleList names."""
    params = variables["params"]
    sd: dict = {}
    idx = 0
    for i in range(4, 0, -1):
        names = [f"upconv_{i}_0", f"upconv_{i}_1"]
        names += ["waveconv_4_ll"] if i == 4 else []
        names += [f"waveconv_{i}_pos", f"waveconv_{i}_neg"]
        for name in names:
            node = params[name]
            if name.startswith("upconv"):
                _conv_to(sd, f"decoder.{idx}.conv.conv", node["conv"])
            else:
                _conv_to(sd, f"decoder.{idx}.0.conv", node["squeeze"])
                _conv_to(sd, f"decoder.{idx}.2.conv", node["conv"])
            idx += 1
    return sd


def state_dicts_from_jax(enc_vars: dict, dec_vars: dict | None):
    """(encoder state dict, decoder state dict) from JAX variable trees;
    the decoder's is None without dec_vars."""
    return (_encoder_state(enc_vars),
            None if dec_vars is None else _decoder_state(dec_vars))


def param_trees_from_jax(enc_tree: dict, dec_tree: dict) -> dict:
    """{port parameter name: tensor} of trees shaped like the encoder's and
    the decoder's params (a gradient or an updated parameter tree), with
    the encoder's names prefixed `encoder.` and the decoder's `depth.`."""
    out = {f"encoder.{k}": v
           for k, v in _encoder_state({"params": enc_tree}).items()}
    out.update({f"depth.{k}": v
                for k, v in _decoder_state({"params": dec_tree}).items()})
    return out


def _fit(module: nn.Module, sd: dict):
    """Split off what `module` has no key for and fill in
    num_batches_tracked. Returns (state dict, dropped, filled, meta)."""
    own = module.state_dict()
    meta = {k: int(sd[k]) for k in _META_KEYS if k in sd}
    dropped = sorted(k for k in sd if k not in own)
    fitted = {k: v for k, v in sd.items() if k in own}
    filled = sorted(k for k in own if k not in sd
                    and k.endswith(".num_batches_tracked"))
    for k in filled:
        fitted[k] = torch.zeros((), dtype=torch.long)
    return fitted, dropped, filled, meta


def load_state_dicts(encoder: nn.Module, decoder: nn.Module,
                     enc_sd: dict, dec_sd: dict) -> dict:
    """Load both state dicts with strict=True after the fix-ups above.
    Returns the report {"meta", "dropped", "filled"}."""
    report = {"meta": {}, "dropped": [], "filled": []}
    for module, sd in ((encoder, enc_sd), (decoder, dec_sd)):
        fitted, dropped, filled, meta = _fit(module, sd)
        module.load_state_dict(fitted, strict=True)
        report["meta"].update(meta)
        report["dropped"] += dropped
        report["filled"] += filled
    return report


def load_reference_checkpoint(folder: str):
    """(encoder.pth, depth.pth) state dicts of a reference checkpoint
    folder, on the CPU."""
    return tuple(torch.load(os.path.join(folder, f), map_location="cpu",
                            weights_only=True)
                 for f in ("encoder.pth", "depth.pth"))


def save_reference_checkpoint(folder: str, encoder: nn.Module,
                              decoder: nn.Module, height: int, width: int,
                              use_stereo: bool = True) -> None:
    """Write a reference-layout folder: encoder.pth (state dict + the
    height / width / use_stereo ints) and depth.pth."""
    os.makedirs(folder, exist_ok=True)
    enc = {k: v.detach().cpu() for k, v in encoder.state_dict().items()}
    enc.update(height=int(height), width=int(width),
               use_stereo=bool(use_stereo))
    torch.save(enc, os.path.join(folder, "encoder.pth"))
    torch.save({k: v.detach().cpu() for k, v in decoder.state_dict().items()},
               os.path.join(folder, "depth.pth"))
