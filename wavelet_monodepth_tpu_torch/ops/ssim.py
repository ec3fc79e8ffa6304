"""SSIM dissimilarity of the photometric loss, NHWC.

Counterpart of `wavelet_monodepth_tpu/ops/ssim.py` (`KITTI/layers.py:
281-311`): reflection-pad 1, 3x3 average pools, C1 = 0.01^2,
C2 = 0.03^2, output clamp((1 - SSIM) / 2, 0, 1).
"""

from __future__ import annotations

import torch

from .image import avg_pool3_valid, pad2d

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM dissimilarity, shape-preserving (N, H, W, C)."""
    x = pad2d(x, 1, "reflect")
    y = pad2d(y, 1, "reflect")
    mu_x = avg_pool3_valid(x)
    mu_y = avg_pool3_valid(y)
    sigma_x = avg_pool3_valid(x * x) - mu_x * mu_x
    sigma_y = avg_pool3_valid(y * y) - mu_y * mu_y
    sigma_xy = avg_pool3_valid(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x ** 2 + mu_y ** 2 + _C1) * (sigma_x + sigma_y + _C2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)
