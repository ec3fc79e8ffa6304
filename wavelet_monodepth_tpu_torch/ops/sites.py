"""Site-compacted sparse engine (the "sites" decoder backend): each conv
of a decoder scale gathers im2col rows for its active output sites only,
runs one GEMM and scatters the rows back.

Counterpart of `wavelet_monodepth_tpu/ops/sites.py`, with the same public
functions and signatures (weights HWIO, activations NHWC). The JAX
package has no Pallas kernel here; this is plain torch index arithmetic,
gathers and `torch.matmul`.

Exact: equal to the masked-dense oracle (`ops/sparse.py`) at every pixel,
borders included, whenever no site set overflows its capacity. Padding
slots hold the out-of-range sentinel N*H*W: gathers clamp their start
(garbage rows, computed and thrown away) and scatters drop them, as JAX's
clipped `dynamic_slice` and `mode="drop"` scatter do; torch indexing does
neither, so both are written out here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .image import pad2d, upsample_nearest2x
from .sparse import stage_masks

Tensor = torch.Tensor


def site_list(mask: Tensor, kcap: int) -> Tensor:
    """Active-site flat ids of an (N, H, W, 1) {0,1} mask, raster order,
    padded to static length kcap with the sentinel N*H*W; sites past kcap
    are dropped. int32 (kcap,)."""
    m = mask.reshape(-1) > 0.5
    total = m.numel()
    slot = torch.cumsum(m, 0) - 1
    pos = torch.where(m & (slot < kcap), slot, kcap)   # kcap = the drop slot
    out = torch.full((kcap + 1,), total, dtype=torch.int32,
                     device=mask.device)
    out.scatter_(0, pos, torch.arange(total, dtype=torch.int32,
                                      device=mask.device))
    return out[:kcap]


def site_overflow(mask: Tensor, kcap: int) -> Tensor:
    """Number of active sites beyond capacity (0 = exact); int32, 0-dim."""
    return torch.clamp((mask > 0.5).sum() - kcap, min=0).to(torch.int32)


def stage_site_overflow(mask: Tensor, cap_lo: float, cap_hi: float,
                        cap_wav: float) -> Tensor:
    """Total dropped sites for one site_wave_stage call (0 = the stage is
    equal to the oracle), from the same three capacities."""
    n, h_l, w_l = mask.shape[0], mask.shape[1], mask.shape[2]
    hh, wh = 2 * h_l, 2 * w_l
    masks = stage_masks(mask)
    return (site_overflow(masks["upconv0"], _cap(n * h_l * w_l, cap_lo))
            + site_overflow(masks["upconv1"], _cap(n * hh * wh, cap_hi))
            + site_overflow(masks["wavelet"], _cap(n * hh * wh, cap_wav)))


def gather_patches(xpad: Tensor, sites: Tensor, height: int,
                   width: int) -> Tensor:
    """im2col rows for 3x3 convs: (K, 9*C) patches around each site, read
    from the reflect-padded dense map.

    Args:
      xpad: (N, H+2, W+2, C) padded input (pad2d of the true map).
      sites: (K,) flat ids in (N, H, W) raster order (sentinel = N*H*W).
      height, width: the unpadded spatial dims.
    Rows are (dy, dx, c) ordered, matching w.reshape(9*C, Cout). Each
    (dy) triple is 3 consecutive pixels of the padded map, read through an
    overlapping (pixels - 2, 3*C) view; its start pixel is clamped into
    the map, so a sentinel reads the last 3 pixels.
    """
    n, hp, wp, c = xpad.shape
    sites = sites.long()
    b = sites // (height * width)
    rem = sites % (height * width)
    y, x = rem // width, rem % width
    base = (b * hp + y + 1) * wp + (x + 1)      # padded centre pixel id
    pixels = n * hp * wp
    triples = xpad.contiguous().reshape(-1).as_strided(
        (pixels - 2, 3 * c), (c, 1))

    def triple(dy):
        return triples[torch.clamp(base + dy * wp - 1, 0, pixels - 3)]

    return torch.cat([triple(-1), triple(0), triple(1)], dim=-1)


def scatter_rows(rows: Tensor, sites: Tensor, n: int, height: int,
                 width: int) -> Tensor:
    """(K, C) compacted rows -> dense (N, H, W, C) zeros map; sentinel
    and overflow slots land in a dump row that is cut off."""
    c = rows.shape[-1]
    out = rows.new_zeros((n * height * width + 1, c))
    out[torch.clamp(sites.long(), max=n * height * width)] = rows
    return out[:-1].reshape(n, height, width, c)


def _cap(n_px: int, ratio: float) -> int:
    return max(8, min(n_px, math.ceil(n_px * ratio)))


def site_wave_stage(x: Tensor, skip: Tensor, mask: Tensor,
                    w0: Tensor, b0: Tensor, w1: Tensor, b1: Tensor,
                    wp1: Tensor, bp1: Tensor, wp3: Tensor, bp3: Tensor,
                    wn1: Tensor, bn1: Tensor, wn3: Tensor, bn3: Tensor,
                    i_scale: int, cap_lo: float = 0.5,
                    cap_hi: float = 0.35, cap_wav: float = 0.25):
    """One sparse decoder scale, site-compacted.

    Args and returns match ops.compact.compact_wave_stage; cap_* are
    fractions of each mask's full pixel count (upconv0 sites at low res,
    upconv1 and wavelet sites at high res). Equal to the oracle at every
    pixel whenever no site set overflows.
    """
    n, h_l, w_l, cx = x.shape
    cs = skip.shape[-1]
    cd = w0.shape[-1]
    hh, wh = 2 * h_l, 2 * w_l
    masks = stage_masks(mask)

    # upconv0 at the low-res upconv0-mask sites
    xp = pad2d(x * masks["lowres"], 1, "reflect")
    s0 = site_list(masks["upconv0"], _cap(n * h_l * w_l, cap_lo))
    p0 = gather_patches(xp, s0, h_l, w_l)                 # (K0, 9Cx)
    r0 = F.elu(p0 @ w0.reshape(9 * cx, cd) + b0)
    x0 = scatter_rows(r0, s0, n, h_l, w_l)                # == x0 * m_u0

    # upsample + concat as split-weight GEMMs at the upconv1 sites
    u = upsample_nearest2x(x0) * masks["upsample"]
    sk = skip * masks["upsample"]
    s1 = site_list(masks["upconv1"], _cap(n * hh * wh, cap_hi))
    pu = gather_patches(pad2d(u, 1, "reflect"), s1, hh, wh)
    ps = gather_patches(pad2d(sk, 1, "reflect"), s1, hh, wh)
    w1r = w1.reshape(3, 3, cd + cs, cd)
    w1x = w1r[:, :, :cd, :].reshape(9 * cd, cd)   # (ky, kx, ci) raster,
    w1s = w1r[:, :, cd:, :].reshape(9 * cs, cd)   # the patch order
    r1 = F.elu(pu @ w1x + ps @ w1s + b1)   # (K1, Cd)
    x1 = scatter_rows(r1, s1, n, hh, wh)                  # == x1 * m_u1

    # fused pos + neg heads: the 1x1 squeeze at the upconv1 sites (the
    # oracle re-masks by m_u1: the rows ARE those sites) ...
    w1h = torch.cat([wp1.reshape(cd, cd), wn1.reshape(cd, cd)], dim=-1)
    hrows = F.leaky_relu(
        r1 @ w1h + torch.cat([bp1, bn1]), 0.1)            # (K1, 2Cd)
    h = scatter_rows(hrows, s1, n, hh, wh)
    # ... and the block-diagonal 3x3 (2Cd -> 6) at the wavelet sites
    sw = site_list(masks["wavelet"], _cap(n * hh * wh, cap_wav))
    pw = gather_patches(pad2d(h, 1, "reflect"), sw, hh, wh)
    w3 = x1.new_zeros((3, 3, 2 * cd, 6))
    w3[:, :, :cd, :3] = wp3
    w3[:, :, cd:, 3:] = wn3
    yw = torch.sigmoid(pw @ w3.reshape(18 * cd, 6) + torch.cat([bp3, bn3]))
    yh_rows = (2.0 ** (i_scale - 1)) * (yw[:, :3] - yw[:, 3:])
    yh = scatter_rows(yh_rows, sw, n, hh, wh)             # == yh * m_wv
    return yh, x1
