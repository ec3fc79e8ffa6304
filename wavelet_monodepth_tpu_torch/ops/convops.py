"""Functional convolutions on NHWC activations with OIHW weights.

Counterpart of `wavelet_monodepth_tpu/ops/convops.py:20-43`. The JAX
functions take HWIO kernels; these take torch's OIHW so module weights
pass straight through. The conv itself is `F.conv2d` on a channels_last
view, which cuDNN runs natively.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import pad2d


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding="VALID", groups: int = 1
           ) -> torch.Tensor:
    """Plain NHWC conv. w: (cout, cin // groups, kh, kw). padding is
    'VALID', 'SAME' or an int."""
    if isinstance(padding, str):
        padding = {"VALID": 0, "SAME": "same"}[padding]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
            pad_mode: str = "reflect", stride: int = 1) -> torch.Tensor:
    """3x3 conv as explicit pad then VALID conv (reflect/replicate/zero)."""
    return conv2d(pad2d(x, 1, pad_mode), w, b, stride=stride)


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor | None = None) -> torch.Tensor:
    return conv2d(x, w, b)
