"""Plain reference of `nyu_densenet161_640x480`: torchvision's DenseNet-161
features (tapped at relu0, pool0, transition1, transition2, denseblock4;
raw [0, 1] input, as every published NYU model saw it) + the NYUv2 wavelet
decoder `DecoderWave` / `SparseDecoderWave` at decoder_width 0.5
(WaveletMonoDepth, `NYUv2/networks/decoders/densedepth_decoder.py`).

State-dict layout of the reference repository's `model.pth`:
`original_model.features.*` (encoder) and `conv2`, `up<k>.convA`,
`wave1_ll`, `wave<k>` (decoder), each 3x3 under `.conv`.

The sparse decoder is the masked-dense form of the reference's sparse
engine at scales 1 and 0 (scales 3 and 2 dense): the raw mask m of a scale
gives the published dilations (`common.stage_masks`); the UpBlock's input
is masked with dilate5(m), its upsample-concat with dilate5(up2(m)), its
output with dilate3(up2(m)), the wave head's output with up2(m).
`total_ops` repeats the reference's analytic counters (the JAX package's
single count of `wave_idxmap` at scale 1) in float64, per image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (Precision, bn_eval, bn_spec, conv, conv3x3, haar_idwt,
                     nchw, nhwc, sparse3x3_ops, stage_masks, up2)

Tensor = torch.Tensor

NUM_CH_ENC = (96, 96, 192, 384, 2208)
BLOCK_CONFIG = (6, 12, 36, 24)
GROWTH, BN_SIZE, INIT = 48, 4, 96
F_DEC = int(NUM_CH_ENC[-1] * 0.5)       # decoder_width 0.5: 1104

PRE = "original_model.features"


def encoder_spec() -> list:
    spec = [(f"{PRE}.conv0.weight", (INIT, 3, 7, 7), "conv_weight")]
    bn_spec(spec, f"{PRE}.norm0", INIT)
    nch = INIT
    for bi, nl in enumerate(BLOCK_CONFIG):
        for li in range(nl):
            pre = f"{PRE}.denseblock{bi + 1}.denselayer{li + 1}"
            cin = nch + li * GROWTH
            bn_spec(spec, f"{pre}.norm1", cin)
            spec.append((f"{pre}.conv1.weight", (BN_SIZE * GROWTH, cin, 1, 1),
                         "conv_weight"))
            bn_spec(spec, f"{pre}.norm2", BN_SIZE * GROWTH)
            spec.append((f"{pre}.conv2.weight",
                         (GROWTH, BN_SIZE * GROWTH, 3, 3), "conv_weight"))
        nch += nl * GROWTH
        if bi != len(BLOCK_CONFIG) - 1:
            pre = f"{PRE}.transition{bi + 1}"
            bn_spec(spec, f"{pre}.norm", nch)
            spec.append((f"{pre}.conv.weight", (nch // 2, nch, 1, 1),
                         "conv_weight"))
            nch //= 2
    return spec


def decoder_convs() -> list:
    """[(name, cin, cout, pad)] of the decoder's 3x3 convs."""
    f = F_DEC
    enc = NUM_CH_ENC
    return [("conv2", enc[-1], f, "replicate"),
            ("up1.convA", f + enc[-2], f // 2, "reflect"),
            ("wave1_ll", f // 2, 1, "replicate"),
            ("wave1", f // 2, 3, "zero"),
            ("up2.convA", f // 2 + enc[-3], f // 4, "reflect"),
            ("wave2", f // 4, 3, "zero"),
            ("up3.convA", f // 4 + enc[-4], f // 8, "reflect"),
            ("wave3", f // 8, 3, "zero")]


def decoder_spec() -> list:
    spec = []
    for name, cin, cout, _ in decoder_convs():
        spec += [(f"{name}.conv.weight", (cout, cin, 3, 3), "conv_weight"),
                 (f"{name}.conv.bias", (cout,), "conv_bias")]
    return spec


def specs() -> dict:
    return {"encoder": encoder_spec(), "decoder": decoder_spec()}


def encoder(x: Tensor, sd: dict, p: Precision) -> list:
    x = F.relu(bn_eval(conv(x, sd[f"{PRE}.conv0.weight"], None, p, 2, 3),
                       sd, f"{PRE}.norm0"))
    feats = [x]
    x = F.max_pool2d(x, 3, 2, 1)
    feats.append(x)
    for bi, nl in enumerate(BLOCK_CONFIG):
        for li in range(nl):
            pre = f"{PRE}.denseblock{bi + 1}.denselayer{li + 1}"
            y = conv(F.relu(bn_eval(x, sd, f"{pre}.norm1")),
                     sd[f"{pre}.conv1.weight"], None, p)
            y = conv(F.relu(bn_eval(y, sd, f"{pre}.norm2")),
                     sd[f"{pre}.conv2.weight"], None, p, 1, 1)
            x = torch.cat([x, y], 1)
        if bi != len(BLOCK_CONFIG) - 1:
            pre = f"{PRE}.transition{bi + 1}"
            x = F.avg_pool2d(conv(F.relu(bn_eval(x, sd, f"{pre}.norm")),
                                  sd[f"{pre}.conv.weight"], None, p), 2, 2)
            if bi < 2:
                feats.append(x)
    feats.append(x)
    return feats


def _c3(x: Tensor, sd: dict, name: str, p: Precision) -> Tensor:
    pad = {n: pm for n, _, _, pm in decoder_convs()}[name]
    return conv3x3(x, sd[f"{name}.conv.weight"], sd[f"{name}.conv.bias"], p,
                   pad)


def decoder(feats: list, sd: dict, p: Precision, raw_masks: dict = None
            ) -> dict:
    """Dense (raw_masks None) or sparse decode: {("disp", s)} for s = 3..0
    and, sparse, {("wavelet_mask", s)} and ("total_ops", -1) (N,)
    float64. raw_masks: {s: (N, 1, h, w)} at s = 1 (H/16) and 0 (H/8)."""
    leaky = lambda t: F.leaky_relu(t, 0.2)     # noqa: E731
    out = {}
    x_m1 = feats[-1]
    n = x_m1.shape[0]
    ops = torch.zeros(n, dtype=torch.float64, device=x_m1.device)
    x = _c3(x_m1, sd, "conv2", p)
    ops += (1 + 9.0 * x_m1.shape[1]) * x_m1.shape[2] * x_m1.shape[3] * F_DEC
    u = torch.cat([up2(x), feats[-2]], 1)
    x = leaky(_c3(u, sd, "up1.convA", p))
    h1, w1 = x.shape[2], x.shape[3]
    ops += (1 + 9.0 * u.shape[1]) * h1 * w1 * x.shape[1]
    ll = 8.0 * _c3(x, sd, "wave1_ll", p)
    h = 4.0 * _c3(x, sd, "wave1", p)
    ops += (1 + 9.0 * x.shape[1]) * h1 * w1 * 4
    out[("disp", 3)] = ll / 8.0
    ll = haar_idwt(ll, h[:, 0:1], h[:, 1:2], h[:, 2:3])
    ops += ll.shape[2] * ll.shape[3]
    out[("disp", 2)] = ll / 4.0
    if raw_masks is not None:
        out[("wavelet_mask", 2)] = torch.ones_like(h[:, :1])
    for s, up, wave, skip in ((1, "up2.convA", "wave2", feats[-3]),
                              (0, "up3.convA", "wave3", feats[-4])):
        if raw_masks is None:
            x = leaky(_c3(torch.cat([up2(x), skip], 1), sd, up, p))
            h = _c3(x, sd, wave, p)
        else:
            m = raw_masks[s].to(x.dtype)
            mk = stage_masks(m)
            hw_lo = m.shape[2] * m.shape[3]
            hw_hi = skip.shape[2] * skip.shape[3]
            ops += (3 + 125 + 1) * hw_lo + 3 * hw_hi
            u = torch.cat([up2(x * mk["upconv0"]), skip], 1) * mk["upsample"]
            x = leaky(_c3(u, sd, up, p)) * mk["upconv1"]
            h = _c3(x, sd, wave, p) * mk["wavelet"]
            ops += sparse3x3_ops(mk["upconv1"].double().sum(dim=(1, 2, 3)),
                              u.shape[1], x.shape[1])
            ops += sparse3x3_ops(mk["wavelet"].double().sum(dim=(1, 2, 3)),
                              x.shape[1], 3)
            out[("wavelet_mask", s)] = mk["wavelet"]
        h = (2.0 ** s) * h
        ll = haar_idwt(ll, h[:, 0:1], h[:, 1:2], h[:, 2:3])
        if raw_masks is not None:
            ops += ll.shape[2] * ll.shape[3]
        out[("disp", s)] = ll / (2.0 ** s)
    if raw_masks is not None:
        out[("total_ops", -1)] = ops
    return out


def serve(frames: Tensor, sd: dict, p: Precision, raw_masks: dict = None
          ) -> dict:
    """One request: uint8 frames (N, H, W, 3) -> {"disp": (N, H/2, W/2, 1)}
    (scale 0), and sparse "masks" {("wavelet_mask", s): (N, h, w, 1)} and
    "total_ops" (N,). raw_masks: {s: (N, h, w, 1)} at s = 1, 0."""
    x = nchw(frames.float()) / 255.0
    rm = None if raw_masks is None else {s: nchw(m) for s, m in
                                         raw_masks.items()}
    out = decoder(encoder(x, sd, p), sd, p, rm)
    res = {"disp": nhwc(out[("disp", 0)])}
    if rm is not None:
        res["masks"] = {k: nhwc(v) for k, v in out.items()
                        if k[0] == "wavelet_mask"}
        res["total_ops"] = out[("total_ops", -1)]
    return res
