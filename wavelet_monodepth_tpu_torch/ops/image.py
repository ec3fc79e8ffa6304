"""Image-space primitives on NHWC tensors: padding, nearest upsampling,
mask dilation, bilinear resize and warp, smoothness loss.

Counterpart of `wavelet_monodepth_tpu/ops/image.py`. Each function takes
and returns NHWC and runs the NCHW torch op on a permuted view
(channels_last memory, no copy). `grid_sample_border` is
`F.grid_sample(padding_mode="border", align_corners=False)`: the JAX
package's gather warp and its TPU-only batch-chunked take
(`ops/image.py:98-204`, an XLA operand-size workaround) have no CUDA
counterpart to port. Under a spatial layout's `at_rows` scope,
`pad2d` and `max_pool_same` take a band's rows from its neighbours
(`parallel/spatial_hints.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import mesh, spatial_hints

_PAD_MODES = {"reflect": "reflect", "zero": "constant",
              "replicate": "replicate"}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def pad2d(x: torch.Tensor, pad: int = 1, mode: str = "reflect"
          ) -> torch.Tensor:
    """Spatial padding of an NHWC tensor; mode is 'reflect', 'zero' or
    'replicate' (torch ReflectionPad2d / ZeroPad2d / ReplicationPad2d).
    A band of a spatial layout takes its `pad` halo rows from its
    neighbours and pads in `mode` at the image border only."""
    band = spatial_hints.band_of(x)
    if band is not None:
        x = band.pad_rows(x, pad, pad, mode)
        return _nhwc(F.pad(_nchw(x), (pad, pad, 0, 0),
                           mode=_PAD_MODES[mode]))
    return _nhwc(F.pad(_nchw(x), (pad, pad, pad, pad),
                       mode=_PAD_MODES[mode]))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling of NHWC."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def _interp_matrix_ac(out_n: int, in_n: int, like: torch.Tensor
                      ) -> torch.Tensor:
    """(out_n, in_n) corner-aligned 1-D linear interpolation matrix, its
    positions and weights computed in float64, in like's dtype and
    device (2 nonzeros per row)."""
    pos = (np.linspace(0.0, in_n - 1.0, out_n) if out_n > 1
           else np.zeros((1,)))
    i0 = np.minimum(np.floor(pos).astype(np.int64), in_n - 1)
    i1 = np.minimum(i0 + 1, in_n - 1)
    f = pos - i0
    m = np.zeros((out_n, in_n), np.float64)
    np.add.at(m, (np.arange(out_n), i0), 1.0 - f)
    np.add.at(m, (np.arange(out_n), i1), f)
    return torch.from_numpy(m).to(device=like.device, dtype=like.dtype)


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize with torch `F.interpolate(mode='bilinear')`'s
    semantics, never antialiased.

    align_corners=False is `F.interpolate`; for upsampling (the inference
    tool's use) it equals the JAX package's `jax.image.resize(...,
    'linear')` (when downsampling, JAX antialiases and torch does not).
    align_corners=True (the NYU eval's) is two matmuls with the
    interpolation matrices, as the JAX package computes it
    (`ops/image.py:58-67`): `F.interpolate` takes its source positions
    in float32, up to 2e-4 off on values of 10 at 320 px.
    """
    if align_corners:
        my = _interp_matrix_ac(height, x.shape[1], x)
        mx = _interp_matrix_ac(width, x.shape[2], x)
        return torch.einsum("pw,nowc->nopc", mx,
                            torch.einsum("oh,nhwc->nowc", my, x))
    y = F.interpolate(_nchw(x), size=(height, width), mode="bilinear",
                      align_corners=False)
    return _nhwc(y)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, SAME padding. `F.max_pool2d` pads with
    -inf, so zero masks stay zero at the borders; a band of a spatial
    layout takes its k // 2 halo rows from its neighbours."""
    band = spatial_hints.band_of(x)
    if band is not None:
        x = band.pad_rows(x, k // 2, k // 2, "-inf")
        return _nhwc(F.max_pool2d(_nchw(x), k, stride=1,
                                  padding=(0, k // 2)))
    return _nhwc(F.max_pool2d(_nchw(x), k, stride=1, padding=k // 2))


def dilate_mask(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Dilate a {0,1} float mask with a k x k window."""
    return max_pool_same(mask, k)


def avg_pool3_valid(x: torch.Tensor) -> torch.Tensor:
    """3x3 average pool, stride 1, VALID (torch AvgPool2d(3, 1)), the SSIM
    building block."""
    return _nhwc(F.avg_pool2d(_nchw(x), 3, stride=1))


def grid_sample_border(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear warp with border clamping: img (N, H, W, C), grid
    (N, Ho, Wo, 2) normalised (x, y) in [-1, 1] under align_corners=False.
    Both are cast to the dtype torch promotes them to."""
    dt = torch.promote_types(img.dtype, grid.dtype)
    out = F.grid_sample(_nchw(img.to(dt)), grid.to(dt), mode="bilinear",
                        padding_mode="border", align_corners=False)
    return _nhwc(out)


def get_smooth_loss(disp: torch.Tensor, img: torch.Tensor,
                    gamma: float = 2.0) -> torch.Tensor:
    """Edge-aware disparity smoothness (`KITTI/layers.py:239-252`); its
    means are the global batch's under data parallelism
    (`parallel/mesh.global_mean`)."""
    grad_disp_x = torch.abs(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    grad_disp_y = torch.abs(disp[:, :-1, :, :] - disp[:, 1:, :, :])
    grad_img_x = torch.mean(torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]),
                            dim=3, keepdim=True)
    grad_img_y = torch.mean(torch.abs(img[:, :-1, :, :] - img[:, 1:, :, :]),
                            dim=3, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-gamma * grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-gamma * grad_img_y)
    return mesh.global_mean(grad_disp_x) + mesh.global_mean(grad_disp_y)


def get_grad_map(img: torch.Tensor, reduce: bool = False) -> torch.Tensor:
    """Per-channel |dx| / |dy| maps, reflect-padded back to the input size;
    channels [grad_x..., grad_y...] (2C, or 2 with reduce=True)."""
    gx = torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :])
    gy = torch.abs(img[:, :-1, :, :] - img[:, 1:, :, :])
    gx = _nhwc(F.pad(_nchw(gx), (0, 1, 0, 0), mode="reflect"))
    gy = _nhwc(F.pad(_nchw(gy), (0, 0, 0, 1), mode="reflect"))
    if reduce:
        gx = gx.mean(dim=3, keepdim=True)
        gy = gy.mean(dim=3, keepdim=True)
    return torch.cat([gx, gy], dim=3)


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """Rescale to [0, 1] for visualisation."""
    ma, mi = x.max(), x.min()
    return (x - mi) / (ma - mi + 1e-5)
