"""Plain reference of `kitti_r18_640x192`: ResNet18 encoder + the KITTI
wavelet decoder (WaveletMonoDepth, `KITTI/networks/`), dense and sparse.

Weights are the reference repository's state-dict layout: the encoder's
`encoder.*` keys (torchvision's ResNet names) and the depth decoder's
`decoder.<k>.*` keys, k counting upconv_i_0, upconv_i_1, (waveconv_4_ll at
i = 4), waveconv_i_pos, waveconv_i_neg for i = 4..1.

The sparse decoder is the masked-dense form of the reference's sparse
engine, which fills inactive neighbours with zeros: at scales 3, 2, 1 a
raw mask m gives the published dilations (`common.stage_masks`), each conv
computes every pixel and the result is multiplied by its output mask;
scale 4 runs dense with an all-ones mask. `total_ops` repeats the
reference's analytic op counters in float64, per image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (Precision, bn_eval, bn_spec, conv, conv3x3, haar_idwt,
                     nchw, nhwc, sparse3x3_ops, stage_masks, up2)

Tensor = torch.Tensor

NUM_CH_ENC = (64, 64, 128, 256, 512)
NUM_CH_DEC = (16, 32, 64, 128, 256)
BLOCKS = (2, 2, 2, 2)


def encoder_spec() -> list:
    """[(key, shape, kind)] of the ResNet18 encoder's state dict."""
    spec = [("encoder.conv1.weight", (64, 3, 7, 7), "conv_weight")]
    bn_spec(spec, "encoder.bn1", 64)
    for stage, nb in enumerate(BLOCKS):
        cin, cout = NUM_CH_ENC[stage], NUM_CH_ENC[stage + 1]
        for b in range(nb):
            pre = f"encoder.layer{stage + 1}.{b}"
            ci = cin if b == 0 else cout
            spec.append((f"{pre}.conv1.weight", (cout, ci, 3, 3),
                         "conv_weight"))
            bn_spec(spec, f"{pre}.bn1", cout)
            spec.append((f"{pre}.conv2.weight", (cout, cout, 3, 3),
                         "conv_weight"))
            bn_spec(spec, f"{pre}.bn2", cout)
            if b == 0 and stage > 0:
                spec.append((f"{pre}.downsample.0.weight", (cout, ci, 1, 1),
                             "conv_weight"))
                bn_spec(spec, f"{pre}.downsample.1", cout)
    return spec


def decoder_blocks() -> list:
    """[(block name, kind, (cin, mid, cout))] in the state dict's order."""
    blocks, cin = [], NUM_CH_ENC[-1]
    for i in range(4, 0, -1):
        c = NUM_CH_DEC[i]
        blocks.append((f"upconv_{i}_0", "convblock", (cin, 0, c)))
        blocks.append((f"upconv_{i}_1", "convblock",
                       (c + NUM_CH_ENC[i - 1], 0, c)))
        if i == 4:
            blocks.append(("waveconv_4_ll", "wave", (c, c // 4, 1)))
        blocks.append((f"waveconv_{i}_pos", "wave", (c, c, 3)))
        blocks.append((f"waveconv_{i}_neg", "wave", (c, c, 3)))
        cin = c
    return blocks


def decoder_spec() -> list:
    spec = []
    for k, (_, kind, (cin, mid, cout)) in enumerate(decoder_blocks()):
        if kind == "convblock":
            spec += [(f"decoder.{k}.conv.conv.weight", (cout, cin, 3, 3),
                      "conv_weight"),
                     (f"decoder.{k}.conv.conv.bias", (cout,), "conv_bias")]
        else:
            spec += [(f"decoder.{k}.0.conv.weight", (mid, cin, 1, 1),
                      "conv_weight"),
                     (f"decoder.{k}.0.conv.bias", (mid,), "conv_bias"),
                     (f"decoder.{k}.2.conv.weight", (cout, mid, 3, 3),
                      "conv_weight"),
                     (f"decoder.{k}.2.conv.bias", (cout,), "conv_bias")]
    return spec


def specs() -> dict:
    return {"encoder": encoder_spec(), "decoder": decoder_spec()}


def _block_keys() -> dict:
    return {name: k for k, (name, _, _) in enumerate(decoder_blocks())}


# --- encoder -----------------------------------------------------------------

def encoder(x: Tensor, sd: dict, p: Precision, bn=bn_eval) -> list:
    """x (N, 3, H, W) in [0, 1] -> [H/2, H/4, ..., H/32] features; `bn`
    is eval-mode BatchNorm (`common.bn_train` for training)."""
    x = (x - 0.45) / 0.225
    x = F.relu(bn(conv(x, sd["encoder.conv1.weight"], None, p, 2, 3),
                       sd, "encoder.bn1"))
    feats = [x]
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, nb in enumerate(BLOCKS):
        for b in range(nb):
            pre = f"encoder.layer{stage + 1}.{b}"
            stride = 2 if (b == 0 and stage > 0) else 1
            y = F.relu(bn(conv(x, sd[f"{pre}.conv1.weight"], None, p,
                                    stride, 1), sd, f"{pre}.bn1"))
            y = bn(conv(y, sd[f"{pre}.conv2.weight"], None, p, 1, 1),
                        sd, f"{pre}.bn2")
            if f"{pre}.downsample.0.weight" in sd:
                x = bn(conv(x, sd[f"{pre}.downsample.0.weight"], None,
                                 p, stride), sd, f"{pre}.downsample.1")
            x = F.relu(y + x)
        feats.append(x)
    return feats


# --- decoder -----------------------------------------------------------------

def _w(sd: dict, k: int, sub: str):
    return sd[f"decoder.{k}.{sub}.weight"], sd[f"decoder.{k}.{sub}.bias"]


def _convblock(x: Tensor, sd: dict, k: int, p: Precision) -> Tensor:
    return F.elu(conv3x3(x, *_w(sd, k, "conv.conv"), p, "reflect"))


def _wave(x: Tensor, sd: dict, k: int, p: Precision, in_mask=None,
          out_mask=None) -> Tensor:
    """sigmoid(conv3x3(leaky_0.1(conv1x1(x)))), with the sparse engine's
    masks: the input and the 1x1's output at in_mask, the result at
    out_mask."""
    if in_mask is not None:
        x = x * in_mask
    h = F.leaky_relu(conv(x, *_w(sd, k, "0.conv"), p), 0.1)
    if in_mask is not None:
        h = h * in_mask
    y = torch.sigmoid(conv3x3(h, *_w(sd, k, "2.conv"), p, "reflect"))
    return y if out_mask is None else y * out_mask


def decoder(feats: list, sd: dict, p: Precision, raw_masks: dict = None
            ) -> dict:
    """Dense (raw_masks None) or sparse decode. Returns {("disp", s): (N, 1,
    H/2^s, W/2^s)}, and in sparse mode also {(mask name, s): mask} for the
    five dilated masks of each scale and ("total_ops", -1): (N,) float64."""
    key = _block_keys()
    out = {}
    x = feats[-1]
    n = x.shape[0]
    sparse = raw_masks is not None
    ops = torch.zeros(n, dtype=torch.float64, device=x.device)
    yl = None
    for i in range(4, 0, -1):
        c, s = NUM_CH_DEC[i], i - 1
        skip = feats[i - 1]
        hw_lo = x.shape[2] * x.shape[3]
        hw_hi = skip.shape[2] * skip.shape[3]
        pos, neg = key[f"waveconv_{i}_pos"], key[f"waveconv_{i}_neg"]
        up0, up1 = key[f"upconv_{i}_0"], key[f"upconv_{i}_1"]
        if sparse and i != 4:
            m = raw_masks[i].to(x.dtype)
            masks = stage_masks(m)
            for name, mk in masks.items():
                out[(f"{name}_mask", s)] = mk
            n0, n_in, n_out = (masks[k].double().sum(dim=(1, 2, 3))
                               for k in ("upconv0", "upconv1", "wavelet"))
            cin0 = x.shape[1]
            x = F.elu(conv3x3(x * masks["lowres"], *_w(sd, up0, "conv.conv"),
                              p, "reflect")) * masks["upconv0"]
            u = torch.cat([up2(x), skip], 1) * masks["upsample"]
            x = F.elu(conv3x3(u, *_w(sd, up1, "conv.conv"), p, "reflect")
                      ) * masks["upconv1"]
            yh = (2.0 ** s) * (
                _wave(x, sd, pos, p, masks["upconv1"], masks["wavelet"])
                - _wave(x, sd, neg, p, masks["upconv1"], masks["wavelet"]))
            ops += (3 + 125 + 2) * hw_lo + 2 * hw_hi
            ops += (sparse3x3_ops(n0, cin0, c)
                    + sparse3x3_ops(n_in, u.shape[1], c))
            ops += 2 * (n_in * c * c + n_in * c + sparse3x3_ops(n_out, c, 3))
        else:
            cin0 = x.shape[1]
            if sparse:           # scale 4 of a sparse decode: all ones
                ones = x.new_ones((n, 1, x.shape[2], x.shape[3]))
                for name, mk in stage_masks(ones).items():
                    out[(f"{name}_mask", s)] = mk
            x = _convblock(x, sd, up0, p)
            u = torch.cat([up2(x), skip], 1)
            x = _convblock(u, sd, up1, p)
            if i == 4:
                yl = 16.0 * _wave(x, sd, key["waveconv_4_ll"], p)
            yh = (2.0 ** s) * (_wave(x, sd, pos, p) - _wave(x, sd, neg, p))
            if sparse:
                ops += 125 * hw_lo
                ops += (1 + 9.0 * cin0 * hw_lo) * c
                ops += (1 + 9.0 * u.shape[1] * hw_hi) * c
                ops += (1 + c * hw_hi) * (c // 4) + (1 + 9.0 * (c // 4)
                                                     * hw_hi)
                ops += 2 * ((1 + c * hw_hi) * c + (1 + 9.0 * c * hw_hi) * 3)
        yl = haar_idwt(yl, yh[:, 0:1], yh[:, 1:2], yh[:, 2:3])
        if sparse:
            ops += 4 * yl.shape[2] * yl.shape[3]
        out[("disp", s)] = torch.clamp(yl / (2.0 ** s), 0, 1)
    if sparse:
        out[("total_ops", -1)] = ops
    return out


def serve(frames: Tensor, sd: dict, p: Precision, raw_masks: dict = None
          ) -> dict:
    """One request as the benchmark serves it: uint8 frames (N, H, W, 3) ->
    {"disp": (N, H, W, 1)} (scale 0), and in sparse mode "masks" {(name,
    s): (N, h, w, 1)} and "total_ops" (N,). raw_masks: {i: (N, h, w, 1)}
    at scales 3, 2, 1."""
    x = nchw(frames.float()) / 255.0
    rm = None if raw_masks is None else {i: nchw(m) for i, m in
                                         raw_masks.items()}
    out = decoder(encoder(x, sd, p), sd, p, rm)
    res = {"disp": nhwc(out[("disp", 0)])}
    if rm is not None:
        res["masks"] = {k: nhwc(v) for k, v in out.items()
                        if k[0].endswith("_mask")}
        res["total_ops"] = out[("total_ops", -1)]
    return res
