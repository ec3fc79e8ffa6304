"""DenseNet-161 encoder, the NYUv2 flagship backbone.

Counterpart of `wavelet_monodepth_tpu/models/densenet.py`
(`NYUv2/networks/encoders/densenet_encoder.py:4-33`): torchvision's
densenet161.features (init features 96, growth 48, bn_size 4, blocks
(6, 12, 36, 24)) tapped at relu0 (H/2, 96), pool0 (H/4, 96), transition1
(H/8, 192), transition2 (H/16, 384) and denseblock4 (H/32, 2208), so
`NUM_CH_ENC = (96, 96, 192, 384, 2208)`. The modules carry torchvision's
names under the reference's `original_model.features` scope, so the
`encoder.` part of a reference NYU `model.pth` loads into it; the final
`norm5` and the classifier, which no tap reads, are not built.

`normalize_input=False` by default: the reference's flag is a silent
no-op (it normalises out of place and drops the result), so every
published NYU model saw raw [0, 1] inputs. True is real ImageNet
mean / std normalisation, for models trained that way.

BatchNorm is `models/resnet.BatchNorm2d` (flax's biased running
variance in train mode). Takes NHWC images and returns NHWC features;
inside, each dense layer concatenates its 48 new channels to its input,
as torchvision and the JAX package do.

The stem conv, each dense layer's 3x3, the stem's max pool and the
transitions' average pools go through `spatial_hints.conv2d` /
`max_pool2d` / `avg_pool2d`, which are the plain ops outside a spatial
layout. Under one (`parallel/spatial_hints.py`, entered by
`mesh.spatial_forward`) each rank runs its band of rows between its
halos, a scale too short to band (at 640x480 over two ranks: H/32, 15
rows) runs whole on every rank, and every feature carries its global
height; the 1x1 convs and eval-mode BN are per pixel. Inference only:
a train-mode BN raises there.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial_hints
from .resnet import BatchNorm2d

NUM_CH_ENC = (96, 96, 192, 384, 2208)
BLOCK_CONFIG = (6, 12, 36, 24)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int = 48, bn_size: int = 4):
        super().__init__()
        self.norm1 = BatchNorm2d(cin, eps=1e-5)
        self.conv1 = nn.Conv2d(cin, bn_size * growth_rate, 1, bias=False)
        self.norm2 = BatchNorm2d(bn_size * growth_rate, eps=1e-5)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = spatial_hints.rows_of(x, 2)
        y = self.conv1(F.relu(self.norm1(x)))
        y = spatial_hints.conv2d(self.conv2, F.relu(self.norm2(y)), rows)[0]
        return spatial_hints.mark(torch.cat([x, y], dim=1), rows)


class DenseBlock(nn.Module):
    def __init__(self, cin: int, num_layers: int, growth_rate: int = 48):
        super().__init__()
        for li in range(num_layers):
            self.add_module(f"denselayer{li + 1}",
                            DenseLayer(cin + li * growth_rate, growth_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = BatchNorm2d(cin, eps=1e-5)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = spatial_hints.rows_of(x, 2)
        return spatial_hints.avg_pool2d(self.conv(F.relu(self.norm(x))),
                                        rows)[0]


class _Features(nn.Module):
    """torchvision's densenet161.features up to denseblock4."""

    def __init__(self, init_features: int = 96, growth_rate: int = 48):
        super().__init__()
        self.conv0 = nn.Conv2d(3, init_features, 7, 2, 3, bias=False)
        self.norm0 = BatchNorm2d(init_features, eps=1e-5)
        nch = init_features
        for bi, num_layers in enumerate(BLOCK_CONFIG):
            self.add_module(f"denseblock{bi + 1}",
                            DenseBlock(nch, num_layers, growth_rate))
            nch += num_layers * growth_rate
            if bi != len(BLOCK_CONFIG) - 1:
                self.add_module(f"transition{bi + 1}",
                                Transition(nch, nch // 2))
                nch //= 2


class DenseNet161Encoder(nn.Module):
    """Returns [relu0 (H/2), pool0 (H/4), transition1 (H/8), transition2
    (H/16), denseblock4 (H/32)], NHWC. BN follows the module's mode: call
    `.eval()` for inference."""

    num_ch_enc = NUM_CH_ENC

    def __init__(self, normalize_input: bool = False):
        super().__init__()
        self.normalize_input = normalize_input
        self.original_model = nn.Module()
        self.original_model.features = _Features()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        rows = spatial_hints.rows_of(x)
        x = spatial_hints.hint(x, rows)
        if self.normalize_input:
            x = ((x - x.new_tensor(_MEAN)) / x.new_tensor(_STD))
        f = self.original_model.features
        x, rows = spatial_hints.conv2d(f.conv0, x.permute(0, 3, 1, 2), rows)
        x = spatial_hints.mark(F.relu(f.norm0(x)), rows)
        feats = [x]
        x = spatial_hints.max_pool2d(x, rows, 3, 2, 1)[0]
        feats.append(x)
        for bi in range(len(BLOCK_CONFIG)):
            x = getattr(f, f"denseblock{bi + 1}")(x)
            if bi != len(BLOCK_CONFIG) - 1:
                x = getattr(f, f"transition{bi + 1}")(x)
                if bi < 2:
                    feats.append(x)
        feats.append(x)
        return [spatial_hints.mark(t.permute(0, 2, 3, 1),
                                   spatial_hints.rows_of(t, 2))
                for t in feats]
