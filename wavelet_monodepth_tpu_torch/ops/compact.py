"""Whole-stage tile compaction: one sparse decoder scale on a compacted
batch of active tiles (the "compact" decoder backend).

Counterpart of `wavelet_monodepth_tpu/ops/compact.py`, with the same
public functions and signatures; weights are HWIO, activations NHWC, as
there. One decoder scale (upconv0 -> nearest-x2 upsample + skip concat
-> upconv1 -> fused pos/neg heads) runs on the top-K active (th x tw)
tiles of the whole batch (K = ceil(cap_ratio * N * nT), fixed by
capacity, not by how many tiles are active):

  1. halo windows of x, skip and the stage masks are gathered for the K
     tiles: io="pallas" through the block IO kernels K5/K6
     (`ops/blockio.py`, `csrc/blockio.cu`), io="xla" by pre-tiling and
     indexing in torch;
  2. the stage runs as stock `F.conv2d` over the (K, ...) tile batch, as
     the JAX package leaves it to XLA;
  3. yh and the next scale's features are scattered back (inactive tiles
     are exact zeros under the stage masks).

Exactness: equal to the masked-dense oracle (`ops/sparse.py`) at every
pixel further than 2 high-res px from the image border whenever the
active tiles fit in K (tiles reflect-pad their inputs, the oracle pads
intermediate features). Past capacity the lowest-activity tiles are
dropped; ties go to the lower tile index, as `jax.lax.top_k` breaks them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import blockio
from .image import pad2d, upsample_nearest2x
from .sparse import stage_masks

Tensor = torch.Tensor


def _pretile(x: Tensor, th: int, tw: int, nh: int, nw: int, halo: int,
             pad_mode: str = "reflect") -> Tensor:
    """(N, H, W, C) -> (N * nh * nw, th + 2*halo, tw + 2*halo, C) halo
    windows: the image padded by `halo` with pad_mode, zero-extended to
    the tile grid, cut into nh row slabs x nw column slabs."""
    n, h, w, c = x.shape
    if halo:
        x = pad2d(x, halo, pad_mode)
    x = F.pad(x, (0, 0, 0, nw * tw + 2 * halo - x.shape[2],
                  0, nh * th + 2 * halo - x.shape[1]))
    rows = torch.stack([x[:, i * th:i * th + th + 2 * halo]
                        for i in range(nh)], dim=1)   # (N, nh, th+2h, Wp, C)
    tiles = torch.stack([rows[:, :, :, j * tw:j * tw + tw + 2 * halo]
                         for j in range(nw)], dim=2)
    return tiles.reshape(n * nh * nw, th + 2 * halo, tw + 2 * halo, c)


def _scatter(vals: Tensor, idx: Tensor, n: int, nh: int, nw: int,
             th: int, tw: int, h: int, w: int) -> Tensor:
    """(K, th, tw, C) compacted tiles -> dense (N, H, W, C); unselected
    tiles are zeros (exact: their stage masks are all zero)."""
    c = vals.shape[-1]
    out = vals.new_zeros((n * nh * nw, th, tw, c))
    out[idx] = vals
    out = out.reshape(n, nh, nw, th, tw, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n, nh * th, nw * tw, c)
    return out[:, :h, :w]


def default_tile_shape(hh: int, wh: int) -> tuple[int, int]:
    """High-res tile shape for a stage with high-res dims (hh, wh): (8, 32)
    when the image is >= 64 wide, shrunk (to multiples of 8, even so the
    low-res tile is integral) on small scales. th = 8 keeps the low-res
    tile (4 rows) >= 2*halo, the block IO band invariant."""
    th = 8
    tw = 32 if wh >= 64 else max(16, min(32, -(-wh // 16) * 8))
    return th, tw


def tile_scores(mask: Tensor, th: int, tw: int) -> Tensor:
    """Per-tile active-pixel counts of an (N, H, W, 1) mask, flattened to
    (N * nT,) in the order `_pretile` emits tiles."""
    n, h, w = mask.shape[0], mask.shape[1], mask.shape[2]
    nh, nw = -(-h // th), -(-w // tw)
    m = F.pad(mask[..., 0], (0, nw * tw - w, 0, nh * th - h))
    return m.reshape(n, nh, th, nw, tw).sum(dim=(2, 4)).reshape(-1)


def stage_overflow(upconv1_mask: Tensor, th: int, tw: int,
                   capacity: int) -> Tensor:
    """Active tiles beyond capacity for a stage's upconv1 mask (0 = the
    compacted stage is exact in the interior); int32, 0-dim."""
    active = (tile_scores(upconv1_mask, th, tw) > 0).sum()
    return torch.clamp(active - capacity, min=0).to(torch.int32)


def _capacity(n: int, n_tiles: int, cap_ratio: float) -> int:
    """K: one pool over the whole batch, rounded up."""
    return min(n * n_tiles, max(1, math.ceil(n * n_tiles * cap_ratio)))


def stage_capacity_overflow(mask: Tensor, th: int, tw: int,
                            cap_ratio: float) -> Tensor:
    """Dropped active tiles for one compact_wave_stage call (0 = the stage
    matches the oracle in the interior), from its K and tile scores."""
    n, h_l, w_l = mask.shape[0], mask.shape[1], mask.shape[2]
    nh, nw = -(-2 * h_l // th), -(-2 * w_l // tw)
    k = _capacity(n, nh * nw, cap_ratio)
    return stage_overflow(stage_masks(mask)["upconv1"], th, tw, k)


def _conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """VALID conv of NHWC x with an HWIO w."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    b).permute(0, 2, 3, 1)


def _stage_compute(xg, sg, m_u0, m_up, m_u1, m_wv,
                   w0, b0, w1, b1, wp1, bp1, wp3, bp3,
                   wn1, bn1, wn3, bn3, i_scale):
    """The decoder scale on a compacted (K, ...) tile batch. Inputs are
    halo windows: xg (K, hlt+4, wlt+4, Cx), sg (K, th+4, tw+4, Cs), masks
    at their own halos."""
    cd = w0.shape[-1]
    x0 = F.elu(_conv(xg, w0, b0)) * m_u0               # (K, hlt+2, wlt+2, Cd)
    u = upsample_nearest2x(x0) * m_up                  # (K, th+4, tw+4, Cd)
    x1 = F.elu(_conv(torch.cat([u, sg], dim=-1), w1, b1)) * m_u1

    # fused pos + neg heads: one 1x1 (Cd -> 2Cd), one block-diagonal 3x3
    # (2Cd -> 6); the zero blocks add exact zeros
    hcat = _conv(x1, torch.cat([wp1, wn1], dim=-1), torch.cat([bp1, bn1]))
    hcat = F.leaky_relu(hcat, 0.1) * m_u1
    w3 = x1.new_zeros((3, 3, 2 * cd, 6))
    w3[:, :, :cd, :3] = wp3
    w3[:, :, cd:, 3:] = wn3
    y = torch.sigmoid(_conv(hcat, w3, torch.cat([bp3, bn3])))  # (K, th, tw, 6)
    yh_t = (2.0 ** (i_scale - 1)) * (y[..., :3] - y[..., 3:]) * m_wv
    return yh_t, x1[:, 1:-1, 1:-1, :]


def compact_wave_stage(x: Tensor, skip: Tensor, mask: Tensor,
                       w0: Tensor, b0: Tensor, w1: Tensor, b1: Tensor,
                       wp1: Tensor, bp1: Tensor, wp3: Tensor, bp3: Tensor,
                       wn1: Tensor, bn1: Tensor, wn3: Tensor, bn3: Tensor,
                       i_scale: int, th: int = 8, tw: int = 32,
                       cap_ratio: float = 0.5, io: str = "pallas"):
    """One sparse decoder scale on a compacted active-tile batch.

    Args:
      x: (N, Hl, Wl, Cx) scale entry features (already masked by the
         previous stage's upconv1 mask, as the decoder chains them).
      skip: (N, 2Hl, 2Wl, Cs) encoder skip.
      mask: (N, Hl, Wl, 1) raw threshold mask for this scale.
      w0/b0: upconv0 (3x3 HWIO, Cx->Cd). w1/b1: upconv1 (3x3, Cd+Cs->Cd).
      wp*/wn*: pos/neg waveconv head params (1x1 Cd->Cd, 3x3 Cd->3).
      th, tw: high-res tile shape. cap_ratio: K = ceil(ratio * N * nT).
      io: "pallas" = the block IO kernels K5/K6; "xla" = pre-tile + index
          in torch.
    Returns yh (N, 2Hl, 2Wl, 3) and x1 (N, 2Hl, 2Wl, Cd), exactly zero
    outside their stage masks.
    """
    if io not in ("pallas", "xla"):
        raise ValueError(f"io is 'pallas' or 'xla', not {io!r}")
    n, h_l, w_l, _ = x.shape
    hh, wh = 2 * h_l, 2 * w_l
    hlt, wlt = th // 2, tw // 2
    nh, nw = -(-hh // th), -(-wh // tw)
    n_tiles = nh * nw
    k = _capacity(n, n_tiles, cap_ratio)

    masks = stage_masks(mask)
    # dense pre-masking: the oracle's input masking, so halos see it
    x = x * masks["lowres"]
    skip = skip * masks["upsample"]

    # top-K active tiles across the whole batch; a stable descending sort
    # breaks ties by lower index first, as jax.lax.top_k does
    scores = tile_scores(masks["upconv1"], th, tw)
    tid = torch.sort(scores, descending=True, stable=True).indices[:k]

    prm = (w0, b0, w1, b1, wp1, bp1, wp3, bp3, wn1, bn1, wn3, bn3)
    if io == "pallas":
        idx = torch.stack([tid // n_tiles, (tid // nw) % nh, tid % nw],
                          dim=-1).to(torch.int32)
        gather = blockio.band_gather
        stack = blockio.wtile_stack
        # low-res tiles share the same (n, ty, tx) grid at half size
        xg = gather(stack(x, hlt, wlt, 2), idx, hlt, hlt + 4)
        sg = gather(stack(skip, th, tw, 2), idx, th, th + 4)
        m_u0 = gather(stack(masks["upconv0"], hlt, wlt, 1), idx, hlt,
                      hlt + 2)
        m_up = gather(stack(masks["upsample"], th, tw, 2), idx, th, th + 4)
        m_u1 = gather(stack(masks["upconv1"], th, tw, 1), idx, th, th + 2)
        m_wv = gather(stack(masks["wavelet"], th, tw, 0), idx, th, th)
        yh_t, x1_t = _stage_compute(xg, sg, m_u0, m_up, m_u1, m_wv,
                                    *prm, i_scale=i_scale)
        yh = blockio.block_scatter(yh_t.contiguous(), idx, n, nh, nw)
        x1d = blockio.block_scatter(x1_t.contiguous(), idx, n, nh, nw)
        return yh[:, :hh, :wh], x1d[:, :hh, :wh]

    def take(t):
        return t[tid]

    xg = take(_pretile(x, hlt, wlt, nh, nw, 2))
    sg = take(_pretile(skip, th, tw, nh, nw, 2))
    m_u0 = take(_pretile(masks["upconv0"], hlt, wlt, nh, nw, 1))
    m_up = take(_pretile(masks["upsample"], th, tw, nh, nw, 2))
    m_u1 = take(_pretile(masks["upconv1"], th, tw, nh, nw, 1))
    m_wv = take(_pretile(masks["wavelet"], th, tw, nh, nw, 0))
    yh_t, x1_t = _stage_compute(xg, sg, m_u0, m_up, m_u1, m_wv,
                                *prm, i_scale=i_scale)
    return (_scatter(yh_t, tid, n, nh, nw, th, tw, hh, wh),
            _scatter(x1_t, tid, n, nh, nw, th, tw, hh, wh))
