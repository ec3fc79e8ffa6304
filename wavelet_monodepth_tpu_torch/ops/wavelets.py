"""Single-level 2-D Haar DWT/IDWT on NHWC tensors (reshape + butterfly).

Counterpart of `wavelet_monodepth_tpu/ops/wavelets.py:28-101`. With
orthonormal Haar filters each 2x2 output block of the inverse is

    out[2i,   2j  ] = (ll + h0 + h1 + h2) / 2
    out[2i,   2j+1] = (ll + h0 - h1 - h2) / 2
    out[2i+1, 2j  ] = (ll - h0 + h1 - h2) / 2
    out[2i+1, 2j+1] = (ll - h0 - h1 + h2) / 2

with (h0, h1, h2) = (LH, HL, HH) in pytorch_wavelets order. The forward
transform is its exact inverse.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def haar_idwt(ll: torch.Tensor, lh: torch.Tensor, hl: torch.Tensor,
              hh: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) subbands -> (N, 2H, 2W, C) reconstruction."""
    n, h, w, c = ll.shape
    a = (ll + lh + hl + hh) * 0.5   # (2i,   2j)
    b = (ll + lh - hl - hh) * 0.5   # (2i,   2j+1)
    d = (ll - lh + hl - hh) * 0.5   # (2i+1, 2j)
    e = (ll - lh - hl + hh) * 0.5   # (2i+1, 2j+1)
    top = torch.stack([a, b], dim=3).reshape(n, h, 2 * w, c)
    bot = torch.stack([d, e], dim=3).reshape(n, h, 2 * w, c)
    return torch.stack([top, bot], dim=2).reshape(n, 2 * h, 2 * w, c)


def haar_dwt(x: torch.Tensor):
    """(N, 2H, 2W, C) -> (ll, lh, hl, hh), each (N, H, W, C)."""
    n, h2, w2, c = x.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"haar_dwt needs even H and W, got {h2}x{w2}")
    h, w = h2 // 2, w2 // 2
    x = x.reshape(n, h, 2, w, 2, c)
    x00 = x[:, :, 0, :, 0, :]
    x01 = x[:, :, 0, :, 1, :]
    x10 = x[:, :, 1, :, 0, :]
    x11 = x[:, :, 1, :, 1, :]
    ll = (x00 + x01 + x10 + x11) * 0.5
    lh = (x00 + x01 - x10 - x11) * 0.5
    hl = (x00 - x01 + x10 - x11) * 0.5
    hh = (x00 - x01 - x10 + x11) * 0.5
    return ll, lh, hl, hh


def haar_dwt_J(x: torch.Tensor, J: int):
    """J-level forward Haar DWT. Returns (yl, [level-1 (lh, hl, hh), ...,
    level-J]) with level 1 the finest; an odd intermediate LL is
    edge-padded to even first."""
    highs = []
    ll = x
    for _ in range(J):
        _, h, w, _ = ll.shape
        if h % 2 or w % 2:
            ll = F.pad(ll.permute(0, 3, 1, 2), (0, w % 2, 0, h % 2),
                       mode="replicate").permute(0, 2, 3, 1)
        ll, lh, hl, hh = haar_dwt(ll)
        highs.append((lh, hl, hh))
    return ll, highs


def haar_idwt_stacked(yl: torch.Tensor, yh: torch.Tensor) -> torch.Tensor:
    """IDWT with yh (N, H, W, C, 3) holding (LH, HL, HH) on the last axis."""
    return haar_idwt(yl, yh[..., 0], yh[..., 1], yh[..., 2])
