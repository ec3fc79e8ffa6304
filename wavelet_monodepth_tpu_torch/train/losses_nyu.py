"""The NYU losses the reference ships besides its training loss.

Counterpart of `wavelet_monodepth_tpu/train/losses_nyu.py` (the
reference's `NYUv2/loss.py`): a windowed SSIM with a Gaussian kernel,
Laina's BerHu and a border-cropped L1, on NHWC tensors. The NYU train
step uses none of them (it trains on plain L1, `NYUv2/train.py:255`), as
in JAX. The reference's `SpatialGradientsLoss` is dead code and is not
reproduced.

Under data parallelism (`parallel/mesh.py`) each mean over the batch is
the global batch's (`mesh.global_mean`), and BerHu's threshold is the
global batch's largest error (`mesh.global_max`), as under JAX's data
mesh; with one rank they are the plain means.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import mesh

Tensor = torch.Tensor


def _gaussian_window(window_size: int, sigma: float = 1.5,
                     device=None) -> Tensor:
    g = torch.tensor([math.exp(-(x - window_size // 2) ** 2
                               / (2.0 * sigma ** 2))
                      for x in range(window_size)], dtype=torch.float32,
                     device=device)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim_windowed(img1: Tensor, img2: Tensor, val_range: float,
                  window_size: int = 11, size_average: bool = True,
                  full: bool = False):
    """Gaussian-window SSIM (`loss.py:22-59`): VALID padding, each channel
    filtered on its own, L = val_range."""
    n, h, w, c = img1.shape
    real = min(window_size, h, w)
    win = _gaussian_window(real, device=img1.device).to(img1.dtype)
    win = win[None, None].expand(c, 1, real, real)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), win,
                        groups=c).permute(0, 2, 3, 1)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    c1 = (0.01 * val_range) ** 2
    c2 = (0.03 * val_range) ** 2
    v1 = 2.0 * s12 + c2
    v2 = s1 + s2 + c2
    cs = mesh.global_mean(v1 / v2)
    ssim_map = ((2 * mu12 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    ret = (mesh.global_mean(ssim_map) if size_average
           else torch.mean(ssim_map, dim=(1, 2, 3)))
    return (ret, cs) if full else ret


def berhu_loss(pred: Tensor, target: Tensor) -> Tensor:
    """Laina et al.'s reverse Huber (`loss.py:107-124`)."""
    diff = torch.abs(pred - target)
    c = 0.2 * mesh.global_max(torch.max(diff))
    loss = torch.where(diff < c, diff,
                       (diff ** 2 + c ** 2) / (2 * c + 1e-9))
    return mesh.global_mean(loss)


def cropped_l1_loss(pred: Tensor, target: Tensor,
                    crop_border: int = 2) -> Tensor:
    """L1 with a zeroed border of `crop_border` pixels (`loss.py:126-138`)."""
    diff = torch.abs(pred - target)
    mask = torch.zeros_like(target)
    mask[:, crop_border:target.shape[1] - crop_border,
         crop_border:target.shape[2] - crop_border, :] = 1.0
    return mesh.global_mean(diff * mask)
