"""Image-space primitives on NHWC tensors: padding, nearest upsampling,
mask dilation and bilinear resize.

Counterpart of `wavelet_monodepth_tpu/ops/image.py:18-87`. Each function
takes and returns NHWC and runs the NCHW torch op on a permuted view
(channels_last memory, no copy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PAD_MODES = {"reflect": "reflect", "zero": "constant",
              "replicate": "replicate"}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def pad2d(x: torch.Tensor, pad: int = 1, mode: str = "reflect"
          ) -> torch.Tensor:
    """Spatial padding of an NHWC tensor; mode is 'reflect', 'zero' or
    'replicate' (torch ReflectionPad2d / ZeroPad2d / ReplicationPad2d)."""
    return _nhwc(F.pad(_nchw(x), (pad, pad, pad, pad),
                       mode=_PAD_MODES[mode]))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling of NHWC."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize, torch `F.interpolate(mode='bilinear')` semantics.

    For upsampling (the inference tool's use) this equals the JAX
    package's `jax.image.resize(..., 'linear')`; when downsampling, JAX
    antialiases and torch does not.
    """
    y = F.interpolate(_nchw(x), size=(height, width), mode="bilinear",
                      align_corners=align_corners)
    return _nhwc(y)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, SAME padding. `F.max_pool2d` pads with
    -inf, so zero masks stay zero at the borders."""
    return _nhwc(F.max_pool2d(_nchw(x), k, stride=1, padding=k // 2))


def dilate_mask(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Dilate a {0,1} float mask with a k x k window."""
    return max_pool_same(mask, k)
