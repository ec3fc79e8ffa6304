"""MobileNetV2 encoder.

Counterpart of `wavelet_monodepth_tpu/models/mobilenetv2.py`
(`KITTI/networks/encoders/mobilenetv2_encoder.py:80-164`, torchvision's
MobileNetV2 without the classifier and the last [6, 320, 1, 1] stage):
the stem's output and the first block of each stride-2 stage are
tapped; with `use_last_layer` the 1280-channel 1x1 layer, run on the
last block's output, replaces the coarsest tap. `num_ch_enc` is
(32, 24, 32, 64, 1280), or (32, 24, 32, 64, 160) without it.

The modules carry the reference's names, `features.<i>` with
torchvision's Sequential indices: ConvBNReLU6 is (conv, bn, ReLU6); an
inverted residual's `.conv` is [pw ConvBNReLU6, dw ConvBNReLU6, Conv2d,
BatchNorm2d], and [dw ConvBNReLU6, Conv2d, BatchNorm2d] for the
expand-1 first block. BatchNorm is `models/resnet.BatchNorm2d`. Takes
NHWC images (no input normalisation, as the reference) and returns NHWC
features.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..parallel import spatial_hints
from .resnet import BatchNorm2d

# (expand_ratio t, channels c, repeats n, stride s)
_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
             (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2))


def num_ch_enc(use_last_layer: bool = True) -> tuple[int, ...]:
    return (32, 24, 32, 64, 1280 if use_last_layer else 160)


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1,
             groups: int = 1, relu: bool = True) -> list[nn.Module]:
    layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                        groups=groups, bias=False),
              BatchNorm2d(cout, eps=1e-5)]
    return layers + [nn.ReLU6()] if relu else layers


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        layers = []
        if expand_ratio != 1:
            layers.append(nn.Sequential(*_conv_bn(cin, hidden, 1)))
        layers.append(nn.Sequential(*_conv_bn(hidden, hidden, 3, stride,
                                              groups=hidden)))
        layers += _conv_bn(hidden, cout, 1, relu=False)
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


class MobileNetV2Encoder(nn.Module):
    """Returns the five taps, NHWC. BN follows the module's mode."""

    def __init__(self, use_last_layer: bool = True, width_mult: float = 1.0):
        super().__init__()
        self.use_last_layer = use_last_layer
        self.num_ch_enc = num_ch_enc(use_last_layer)
        c0 = int(32 * width_mult)
        layers = [nn.Sequential(*_conv_bn(3, c0, 3, 2))]
        self.taps = [0]
        cin = c0
        for t, c, n, s in _SETTINGS:
            cout = int(c * width_mult)
            for rep in range(n):
                layers.append(InvertedResidual(cin, cout,
                                               s if rep == 0 else 1, t))
                cin = cout
                if s == 2 and rep == 0:
                    self.taps.append(len(layers) - 1)
        if use_last_layer:
            layers.append(nn.Sequential(*_conv_bn(cin, 1280, 1)))
        self.features = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        spatial_hints.refuse("MobileNetV2Encoder")
        x = x.permute(0, 3, 1, 2)
        blocks = (self.features[:-1] if self.use_last_layer
                  else self.features)
        feats = []
        for i, layer in enumerate(blocks):
            x = layer(x)
            if i in self.taps:
                feats.append(x)
        if self.use_last_layer:
            feats[-1] = self.features[-1](x)
        return [t.permute(0, 2, 3, 1) for t in feats]
