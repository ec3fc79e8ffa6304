"""Static-shape sparse decoding: thresholded wavelet masks, masked dense
compute, and the reference's analytic op counters.

Counterpart of `wavelet_monodepth_tpu/ops/sparse.py:45-224`. Because the
reference's sparse engine fills inactive neighbours with zeros,

    sparse_conv(x at in_mask) scattered to out_mask
        == nonlin(conv(pad(x * in_mask))) * out_mask

exactly, so the masked-dense ops here are the oracle that the
tile-sparse kernel (`ops/tile_sparse_conv.py`) is held to. Counts that
depend on masks are float32 (N,) tensors on the masks' device; counts of
shapes alone are 0-dim float32 CPU tensors, which add to a device tensor
as a scalar, with no copy to the device.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .convops import conv1x1, conv3x3
from .image import dilate_mask, upsample_nearest2x

Tensor = torch.Tensor


def wavelet_threshold_mask(yl: Tensor, yh: Tensor, thresh_ratio) -> Tensor:
    """{0,1} mask (N, H, W, 1): max |yh| over bands > (max - min of yl,
    per image) * thresh_ratio. yl may be at any resolution."""
    thresh = (yl.amax(dim=(1, 2, 3), keepdim=True)
              - yl.amin(dim=(1, 2, 3), keepdim=True)) * thresh_ratio
    return (yh.abs().amax(dim=-1, keepdim=True) > thresh).to(yl.dtype)


def stage_masks(mask: Tensor) -> dict[str, Tensor]:
    """Dilated per-op masks of one sparse decoder scale: lowres (3x3, low
    res), upconv0 (5x5, low res), upsample (5x5 of the upsampled mask),
    upconv1 (3x3 of the upsampled mask), wavelet (the upsampled mask)."""
    umask = upsample_nearest2x(mask)
    return {
        "lowres": dilate_mask(mask, 3),
        "upconv0": dilate_mask(mask, 5),
        "upsample": dilate_mask(umask, 5),
        "upconv1": dilate_mask(umask, 3),
        "wavelet": umask,
    }


def masked_conv3x3(x: Tensor, w: Tensor, b: Tensor | None,
                   in_mask: Tensor | None, out_mask: Tensor | None,
                   pad_mode: str = "reflect",
                   nonlin: Callable[[Tensor], Tensor] | None = None
                   ) -> Tensor:
    """Sparse 3x3 conv as masked dense compute. w: OIHW."""
    if in_mask is not None:
        x = x * in_mask
    y = conv3x3(x, w, b, pad_mode)
    if nonlin is not None:
        y = nonlin(y)
    if out_mask is not None:
        y = y * out_mask
    return y


def masked_waveconv(x: Tensor, w1: Tensor, b1: Tensor, w3: Tensor,
                    b3: Tensor, in_mask: Tensor | None,
                    out_mask: Tensor | None, pad_mode: str = "reflect",
                    final_nonlin: Callable[[Tensor], Tensor] = torch.sigmoid
                    ) -> Tensor:
    """Sequential(Conv1x1, LeakyReLU(0.1), Conv3x3) under masks; the
    intermediate is re-masked because the reference's 1x1 conv exists
    only at active sites."""
    if in_mask is not None:
        x = x * in_mask
    h = F.leaky_relu(conv1x1(x, w1, b1), negative_slope=0.1)
    if in_mask is not None:
        h = h * in_mask
    y = final_nonlin(conv3x3(h, w3, b3, pad_mode))
    if out_mask is not None:
        y = y * out_mask
    return y


def masked_upsample_concat(x: Tensor, skip: Tensor,
                           out_mask: Tensor | None) -> Tensor:
    """Nearest-x2 the (already masked) features, concat the skip, mask."""
    y = torch.cat([upsample_nearest2x(x), skip], dim=-1)
    if out_mask is not None:
        y = y * out_mask
    return y


def compute_density(outputs: dict, per_image: bool = False) -> Tensor:
    """Fraction of active wavelet coefficients across scales, from the
    ("wavelet_mask", i) entries; (N,) with per_image=True."""
    num = 0.0
    den = 0.0
    for i in range(4):
        k = ("wavelet_mask", i)
        if k in outputs:
            m = outputs[k].float()
            if per_image:
                num = num + m.sum(dim=(1, 2, 3))
                den = den + m.shape[1] * m.shape[2]
            else:
                num = num + m.sum()
                den = den + m.shape[0] * m.shape[1] * m.shape[2]
    if den == 0.0:
        raise ValueError("compute_density: no (\"wavelet_mask\", i) "
                         "entries in outputs — dense-decoder outputs "
                         "have no density (run with thresh_ratio set)")
    return num / den


# Analytic op counters: the reference's accounting, reproduced exactly.

def _scalar(v: float) -> Tensor:
    return torch.tensor(v, dtype=torch.float32)


def ops_mask2idxmap(mask: Tensor) -> Tensor:
    """`mask2idxmap` cost: H*W of the mask."""
    return _scalar(mask.shape[1] * mask.shape[2])


def ops_threshold(mask: Tensor) -> Tensor:
    """Threshold compare cost: 3*H*W."""
    return _scalar(3 * mask.shape[1] * mask.shape[2])


def ops_dilation(mask: Tensor) -> Tensor:
    """Maxpool dilation cost."""
    hw = mask.shape[1] * mask.shape[2]
    return _scalar(25 * hw + 25 * 4 * hw)


def ops_sparse_conv3x3(n_out: Tensor, ichn: int, ochn: int) -> Tensor:
    """Gather + GEMM cost: 9*ichn gathers plus (1 + 9*ichn)*ochn MACs per
    output site."""
    n_out = n_out.float()
    return 9.0 * ichn * n_out + (1.0 + 9.0 * ichn) * n_out * ochn


def ops_sparse_conv1x1(n_in: Tensor, ichn: int, ochn: int) -> Tensor:
    n_in = n_in.float()
    return n_in * ichn * ochn + n_in * ochn


def ops_dense_conv3x3(x_shape, ochn: int) -> Tensor:
    """Dense 3x3 cost as the KITTI reference counts it:
    (1 + 9*C*H*W) * ochn, NHWC shape."""
    _, h, w, c = x_shape
    return _scalar((1.0 + 9.0 * c * h * w) * ochn)


def ops_dense_conv3x3_nyu(x_shape, ochn: int) -> Tensor:
    """Dense 3x3 cost as the NYU reference counts it: (1 + 9*C)*H*W*ochn."""
    _, h, w, c = x_shape
    return _scalar((1.0 + 9.0 * c) * h * w * ochn)


def ops_dense_conv1x1(x_shape, ichn: int, ochn: int) -> Tensor:
    _, h, w, _ = x_shape
    return _scalar((1.0 + ichn * h * w) * ochn)


def ops_idwt(yl_shape) -> Tensor:
    """IDWT cost: 4*H*W of the output."""
    _, h, w, _ = yl_shape
    return _scalar(4.0 * h * w)


def mask_count(mask: Tensor) -> Tensor:
    """Active sites per image, (N,), accumulated in float32 (a bf16 sum
    loses integer exactness past 256 sites)."""
    return mask.float().sum(dim=(1, 2, 3))
