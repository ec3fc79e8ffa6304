"""Capacity-based tile-sparse 3x3 convolution (the "capacity" decoder
backend): per image, gather the top-K active (th x tw) output tiles with
their conv halo, run one dense VALID conv over the (N*K, th+2, tw+2, C)
batch and scatter the results back. Inactive tiles produce zeros.

Counterpart of `wavelet_monodepth_tpu/ops/capacity.py`, with the same
public functions and signatures (weights HWIO, activations NHWC). The JAX
package has no Pallas kernel here: gathers, `F.conv2d` and a scatter.

Exact: equal to the masked-dense oracle whenever each image's active
tiles fit in K (`tile_overflow`). Past capacity the lowest-activity tiles
are dropped; ties go to the lower tile index, as `jax.lax.top_k` breaks
them. K is per image here (ceil by float floor-division), unlike the
compact backend's one pool over the batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .image import pad2d

Tensor = torch.Tensor


def _tile_activity(out_mask: Tensor, th: int, tw: int):
    """(N, H, W, 1) -> per-tile active-pixel counts (N, nT), (hp, wp)."""
    n, h, w = out_mask.shape[0], out_mask.shape[1], out_mask.shape[2]
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    m = F.pad(out_mask[..., 0], (0, wp - w, 0, hp - h))
    m = m.reshape(n, hp // th, th, wp // tw, tw)
    return m.sum(dim=(2, 4)).reshape(n, -1), (hp, wp)


def _capacity(n_tiles: int, capacity_ratio: float) -> int:
    """K slots per image, rounded up by float floor-division as the JAX
    package does."""
    return min(n_tiles, max(1, int(-(-n_tiles * capacity_ratio // 1))))


def tile_overflow(out_mask: Tensor, th: int, tw: int,
                  capacity: int) -> Tensor:
    """Number of active tiles beyond capacity, per image (0 = exact)."""
    act, _ = _tile_activity(out_mask, th, tw)
    return torch.clamp((act > 0).sum(dim=1) - capacity, min=0).to(
        torch.int32)


def conv_capacity_overflow(out_mask: Tensor, th: int = 16, tw: int = 64,
                           capacity_ratio: float = 0.5) -> Tensor:
    """Total dropped active tiles (summed over the batch) for one
    conv3x3_capacity_sparse call with the same defaults (0 = exact)."""
    h, w = out_mask.shape[1], out_mask.shape[2]
    n_tiles = (-(-h // th)) * (-(-w // tw))
    k = _capacity(n_tiles, capacity_ratio)
    return tile_overflow(out_mask, th, tw, k).sum().to(torch.int32)


def conv3x3_capacity_sparse(x: Tensor, w: Tensor, b: Tensor,
                            out_mask: Tensor, pad_mode: str = "reflect",
                            nonlin: Optional[Callable] = None,
                            th: int = 16, tw: int = 64,
                            capacity_ratio: float = 0.5) -> Tensor:
    """Masked 3x3 conv computing only the top-K active (th x tw) tiles.

    Args:
      x: (N, H, W, Cin). w: (3, 3, Cin, Cout) HWIO. b: (Cout,).
      out_mask: (N, H, W, 1) {0,1}.
      capacity_ratio: K = ceil(ratio * n_tiles) compact slots per image.
    Returns (N, H, W, Cout) == nonlin(conv3x3(pad(x))) * out_mask when
    active tiles <= K (see tile_overflow).
    """
    n, h, w_img, cin = x.shape
    cout = w.shape[-1]
    act, (hp, wp) = _tile_activity(out_mask, th, tw)
    n_w = wp // tw
    n_tiles = (hp // th) * n_w
    k = _capacity(n_tiles, capacity_ratio)

    xp = pad2d(x, 1, pad_mode)                       # (N, H+2, W+2, C)
    xp = F.pad(xp, (0, 0, 0, wp - w_img, 0, hp - h))
    idx = torch.sort(act, dim=1, descending=True, stable=True).indices[:, :k]
    ih, iw = idx // n_w, idx % n_w                   # (N, K)
    img = torch.arange(n, device=x.device)[:, None, None, None]
    dev = x.device
    # halo tiles (N, K, th+2, tw+2, C) by advanced indexing
    rows = (ih[..., None] * th + torch.arange(th + 2, device=dev))[..., None]
    cols = (iw[..., None] * tw + torch.arange(tw + 2, device=dev))[:, :, None]
    tiles = xp[img, rows, cols]
    y = F.conv2d(tiles.reshape(n * k, th + 2, tw + 2, cin).permute(0, 3, 1, 2),
                 w.permute(3, 2, 0, 1), b).permute(0, 2, 3, 1)
    if nonlin is not None:
        y = nonlin(y)
    y = y.reshape(n, k, th, tw, cout)

    # the mask's tiles, gathered the same way without the halo
    maskp = F.pad(out_mask, (0, 0, 0, wp - w_img, 0, hp - h))
    mrows = (ih[..., None] * th + torch.arange(th, device=dev))[..., None]
    mcols = (iw[..., None] * tw + torch.arange(tw, device=dev))[:, :, None]
    y = y * maskp[img, mrows, mcols]

    # scatter back (top-K ids are distinct)
    out_tiles = y.new_zeros((n, n_tiles, th, tw, cout))
    out_tiles[img[:, :, 0, 0], idx] = y
    out = out_tiles.reshape(n, hp // th, n_w, th, tw, cout).permute(
        0, 1, 3, 2, 4, 5).reshape(n, hp, wp, cout)
    return out[:, :h, :w_img]
