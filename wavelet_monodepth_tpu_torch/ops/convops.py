"""Functional convolutions on NHWC activations with OIHW weights.

Counterpart of `wavelet_monodepth_tpu/ops/convops.py:20-108`. The JAX
functions take HWIO kernels; these take torch's OIHW so module weights
pass straight through. The conv itself is `F.conv2d` on a channels_last
view, which cuDNN runs natively. `upconv1_polyphase` is JAX's fold of
nearest-x2 + concat + 3x3 conv into per-phase 2x2 convs at low
resolution (the decoders' `use_polyphase`), on `F.conv2d` as JAX's on
XLA convs; it runs in bands under a spatial layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spatial_hints
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


def _poly_collapse(w: torch.Tensor) -> torch.Tensor:
    """Collapse an OIHW (Co, Ci, 3, 3) kernel over a nearest-x2-upsampled
    input into per-phase 2x2 kernels, (4 Co, Ci, 2, 2), phase order
    (r, s) = (0,0), (0,1), (1,0), (1,1) along the output channels.

    Output phase r in {0, 1} (row parity) reads low-res rows {i-1, i}
    (r=0) or {i, i+1} (r=1); the taps that land on one low-res pixel
    sum: r=0: [w0, w1+w2], r=1: [w0+w1, w2] (the same along columns)."""
    rows = (torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], 2),
            torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], 2))
    phases = []
    for wy in rows:                                   # (Co, Ci, 2, 3)
        phases.append(torch.stack([wy[..., 0], wy[..., 1] + wy[..., 2]],
                                  -1))
        phases.append(torch.stack([wy[..., 0] + wy[..., 1], wy[..., 2]],
                                  -1))
    return torch.cat(phases, 0)


def _poly_interleave(y: torch.Tensor, co: int) -> torch.Tensor:
    """(N, h+1, w+1, 4 Co) phase-conv output -> (N, 2h, 2w, Co)."""
    n, hp1, wp1, _ = y.shape
    h, w = hp1 - 1, wp1 - 1
    p00 = y[:, :h, :w, :co]
    p01 = y[:, :h, 1:, co:2 * co]
    p10 = y[:, 1:, :w, 2 * co:3 * co]
    p11 = y[:, 1:, 1:, 3 * co:]
    top = torch.stack([p00, p01], dim=3).reshape(n, h, 2 * w, co)
    bot = torch.stack([p10, p11], dim=3).reshape(n, h, 2 * w, co)
    return torch.stack([top, bot], dim=2).reshape(n, 2 * h, 2 * w, co)


def upconv1_polyphase(x0: torch.Tensor, skip: torch.Tensor,
                      w: torch.Tensor, b: torch.Tensor | None,
                      pad_mode: str = "reflect", nonlin=None
                      ) -> torch.Tensor:
    """conv3x3(concat(upsample_nearest2x(x0), skip)) without the upsample:
    its half of the input is 2x2-constant, so its 3x3 taps collapse into
    per-phase 2x2 kernels at low resolution (4/9 of the MACs), the four
    phases stacked on the output channels. Equal to the composition up to
    float reassociation of the collapsed taps. At the border, reflect and
    replicate padding of the upsampled tensor are both edge padding of x0
    at low resolution; zero stays zero.

    x0: (N, h, w, Cd) before the upsample; skip: (N, 2h, 2w, Cs); w:
    (Co, Cd + Cs, 3, 3) OIHW of the fused conv; b: (Co,) or None.

    Under a spatial layout the caller scopes the output's global height
    (`spatial_hints.at_rows`). A band of x0 takes one row from each
    neighbour (the image border padded in x0's own mode) and yields the
    2b rows of the output's band; a whole x0 upsampled into a banded
    height runs whole and keeps this rank's band, as
    `layers.upsample_concat` does; the skip's 3x3 runs at the output's
    height."""
    cd = x0.shape[-1]
    co = w.shape[0]
    lo_pad = "zero" if pad_mode == "zero" else "replicate"
    with spatial_hints.downsampled():
        yu = conv2d(pad2d(x0, 1, lo_pad), _poly_collapse(w[:, :cd]))
    y = (spatial_hints.hint(_poly_interleave(yu, co))
         + conv3x3(skip, w[:, cd:], None, pad_mode))
    if b is not None:
        y = y + b
    if nonlin is not None:
        y = nonlin(y)
    return y
