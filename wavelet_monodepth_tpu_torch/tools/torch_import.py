"""Weight bridge: JAX variable trees and reference checkpoints to the
port's modules.

Counterpart of the export half of
`wavelet_monodepth_tpu/tools/torch_import.py` (`export_resnet_encoder`,
`export_kitti_wavelet_decoder`, `export_densenet_encoder`,
`export_nyu_wave_decoder`, and the inverse of
`import_mobilenetv2_encoder`), written again here so the port imports
nothing of the JAX package. The port's modules carry the reference's
state-dict names, so:

  * `state_dicts_from_jax(enc_vars, dec_vars)` turns JAX variables
    (nested dicts of numpy arrays) into the port's encoder and decoder
    state dicts, which are, under the reference's `encoder.` / `decoder.`
    scopes, key for key what the JAX exporter writes; it takes the ResNet,
    MobileNetV2 and DenseNet161 encoders and the KITTI wavelet decoder or
    any of the five NYU decoders (depthwise variants included), told
    apart by their trees. `param_trees_from_jax` does the same for
    parameter-shaped trees (a gradient, updated parameters) without BN
    statistics;
  * `load_reference_checkpoint(folder)` reads a reference KITTI
    `encoder.pth` / `depth.pth` pair, and `save_reference_checkpoint`
    writes one; `load_nyu_model_pth(path)` splits a reference NYU
    `model.pth` (`encoder.original_model.features.*`, `decoder.*`) into
    the two modules' state dicts, and `save_nyu_model_pth` writes one;
  * `load_state_dicts(encoder, decoder, enc_sd, dec_sd)` loads either
    with `strict=True` after two reported fix-ups: it drops what the port
    has no module for (torchvision's `encoder.fc.*` classifier, DenseNet's
    unused `norm5` and classifier, and the `height` / `width` /
    `use_stereo` ints, returned as metadata) and fills in BatchNorm's
    `num_batches_tracked`, which the JAX exporter never writes and eval
    mode never reads.
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
    """Encoder variables -> the port module's state dict: ResNet,
    MobileNetV2 or DenseNet161, told apart by the tree."""
    params = variables["params"]
    if "conv0" in params:
        return _densenet_state(variables)
    if "block_0" in params:
        return _mobilenet_state(variables)
    return _resnet_state(variables)


def _resnet_state(variables: dict) -> dict:
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


def _densenet_state(variables: dict) -> dict:
    """DenseNet161Encoder variables -> torchvision's densenet161.features
    names under `original_model.features.`."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    t = "original_model.features."
    sd: dict = {f"{t}conv0.weight": _conv_w(params["conv0"]["kernel"])}
    _take_bn(sd, f"{t}norm0", params["norm0"]["bn"],
             _sub(stats, "norm0", "bn"))
    bi = 1
    while f"block{bi}_layer1" in params:
        li = 1
        while f"block{bi}_layer{li}" in params:
            name = f"block{bi}_layer{li}"
            tl = f"{t}denseblock{bi}.denselayer{li}."
            for k in (1, 2):
                _take_bn(sd, f"{tl}norm{k}", params[name][f"norm{k}"]["bn"],
                         _sub(stats, name, f"norm{k}", "bn"))
                sd[f"{tl}conv{k}.weight"] = _conv_w(
                    params[name][f"conv{k}"]["kernel"])
            li += 1
        name = f"transition{bi}"
        if name in params:
            _take_bn(sd, f"{t}{name}.norm", params[name]["norm"]["bn"],
                     _sub(stats, name, "norm", "bn"))
            sd[f"{t}{name}.conv.weight"] = _conv_w(
                params[name]["conv"]["kernel"])
        bi += 1
    return sd


def _mobilenet_state(variables: dict) -> dict:
    """MobileNetV2Encoder variables -> the reference's `features.<i>`
    names (torchvision's Sequential indices, `models/mobilenetv2.py`)."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    sd: dict = {}

    def put(tconv: str, tbn: str, path: tuple):
        node = _sub(params, *path)
        sd[f"{tconv}.weight"] = _conv_w(node["conv"]["kernel"])
        _take_bn(sd, tbn, node["bn"], _sub(stats, *path, "bn"))

    put("features.0.0", "features.0.1", ("stem",))
    bi = 0
    while f"block_{bi}" in params:
        name, base = f"block_{bi}", f"features.{bi + 1}.conv"
        if "expand" in params[name]:
            put(f"{base}.0.0", f"{base}.0.1", (name, "expand"))
            put(f"{base}.1.0", f"{base}.1.1", (name, "depthwise"))
            put(f"{base}.2", f"{base}.3", (name, "project"))
        else:
            put(f"{base}.0.0", f"{base}.0.1", (name, "depthwise"))
            put(f"{base}.1", f"{base}.2", (name, "project"))
        bi += 1
    if "last" in params:
        put(f"features.{bi + 1}.0", f"features.{bi + 1}.1", ("last",))
    return sd


def _conv_to(sd: dict, t: str, node: dict):
    sd[f"{t}.weight"] = _conv_w(node["kernel"])
    sd[f"{t}.bias"] = _vec(node["bias"])


# the NYU decoders' convs in the JAX exporter's order; the up blocks follow
_NYU_CONVS = ("conv2", "wave1_ll", "wave1", "wave2", "wave3", "wave4",
              "conv5", "conv3")


def _nyu_conv_to(sd: dict, t: str, node: dict):
    """A Conv3x3 ({kernel, bias} -> `.conv.`) or a DWConv3x3 ({depthwise,
    pointwise} -> `.depthwise.` / `.pointwise.`)."""
    if "kernel" in node:
        _conv_to(sd, f"{t}.conv", node)
    else:
        sd[f"{t}.depthwise.weight"] = _conv_w(node["depthwise"])
        sd[f"{t}.pointwise.weight"] = _conv_w(node["pointwise"])


def _nyu_decoder_state(params: dict) -> dict:
    """Any of the five NYU decoders' params -> the reference's names."""
    sd: dict = {}
    for name in _NYU_CONVS:
        if name in params:
            _nyu_conv_to(sd, name, params[name])
    k = 1
    while f"up{k}" in params:
        _nyu_conv_to(sd, f"up{k}.convA", params[f"up{k}"]["convA"])
        k += 1
    return sd


def _decoder_state(variables: dict) -> dict:
    """KittiWaveletDecoder params -> the reference's `decoder.<idx>.`
    ModuleList names; an NYU decoder's -> its named convs."""
    params = variables["params"]
    if "up1" in params:
        return _nyu_decoder_state(params)
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


def state_dicts_from_jax(enc_vars: dict | None, dec_vars: dict | None):
    """(encoder state dict, decoder state dict) from JAX variable trees;
    either is None when its tree is."""
    return (None if enc_vars is None else _encoder_state(enc_vars),
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


def load_nyu_model_pth(path: str):
    """(encoder state dict, decoder state dict) of a reference NYU
    `model.pth` (one state dict under the `encoder.` and `decoder.`
    scopes, `NYUv2/load_save_utils.py`), the scopes stripped, on the
    CPU. Keys under neither scope are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return tuple({k[len(scope):]: v for k, v in sd.items()
                  if k.startswith(scope)}
                 for scope in ("encoder.", "decoder."))


def save_nyu_model_pth(path: str, encoder: nn.Module,
                       decoder: nn.Module) -> None:
    """Write a reference-layout NYU `model.pth`: both modules' state dicts
    under `encoder.` / `decoder.`."""
    sd = {f"encoder.{k}": v.detach().cpu()
          for k, v in encoder.state_dict().items()}
    sd.update({f"decoder.{k}": v.detach().cpu()
               for k, v in decoder.state_dict().items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(sd, path)
