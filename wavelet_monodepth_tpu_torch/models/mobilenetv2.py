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

Every conv goes through `spatial_hints.conv2d`, which is the module's
own conv outside a spatial layout. Under one (`parallel/
spatial_hints.py`, entered by `mesh.spatial_forward`) each rank runs its
band of rows: the stem's 3x3 stride-2 conv and the depthwise 3x3s
between their halos, the 1x1 convs, eval-mode BN and ReLU6 per pixel, a
stride-2 conv whose output is too short to band (at 640x480 over two
ranks: H/32, 15 rows) on its gathered input, whole on every rank; the
residual adds join tensors of one layout, and every feature carries its
global height. Inference only: a train-mode BN raises there.
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


def _conv_bn_run(seq: nn.Sequential, x: torch.Tensor, rows: int
                 ) -> tuple[torch.Tensor, int]:
    """A ConvBNReLU6 `seq` on NCHW `x` of `rows` global rows, its conv
    through `spatial_hints.conv2d`. Returns (y, its global rows), y
    tagged."""
    y, rows = spatial_hints.conv2d(seq[0], x, rows)
    for layer in seq[1:]:
        y = layer(y)
    return spatial_hints.mark(y, rows), rows


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
        y, rows = x, spatial_hints.rows_of(x, 2)
        for seq in self.conv[:-2]:
            y, rows = _conv_bn_run(seq, y, rows)
        y, rows = spatial_hints.conv2d(self.conv[-2], y, rows)
        y = self.conv[-1](y)
        return spatial_hints.mark(x + y if self.use_res else y, rows)


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
        rows = spatial_hints.rows_of(x)
        x = spatial_hints.hint(x, rows).permute(0, 3, 1, 2)
        x, rows = _conv_bn_run(self.features[0], x, rows)
        feats = [x]
        blocks = (self.features[:-1] if self.use_last_layer
                  else self.features)
        for i in range(1, len(blocks)):
            x = blocks[i](x)
            if i in self.taps:
                feats.append(x)
        if self.use_last_layer:
            feats[-1] = _conv_bn_run(self.features[-1], x,
                                     spatial_hints.rows_of(x, 2))[0]
        return [spatial_hints.mark(t.permute(0, 2, 3, 1),
                                   spatial_hints.rows_of(t, 2))
                for t in feats]
