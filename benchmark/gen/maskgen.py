"""Edge-structured wavelet masks from synthetic depth scenes.

A frozen copy of `wavelet_monodepth_tpu_torch/utils/maskgen.py` (with the
Haar DWT of `ops/wavelets.py` and the threshold rule of
`ops/sparse.wavelet_threshold_mask`), so the benchmark's traffic does not
move when the program does. A trained decoder's yh at scale s approximates
the true Haar DWT of the disparity, so the masks of an ideally trained
model are the thresholded true DWT coefficients of the depth. Scenes are
piecewise-smooth KITTI-like disparity maps (ground plane, occluding boxes,
thin poles); their DWT is thresholded with the reference's rule at a ratio
bisected to hit a target aggregate density.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_depth_scene(n: int, h: int, w: int, seed: int = 0
                          ) -> np.ndarray:
    """(n, h, w, 1) float32 disparity in [0, 1]: ground-plane gradient,
    sky, occluding rectangles, thin poles, gentle low-frequency relief."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h)[:, None] * np.ones((1, w))
    xx = np.ones((h, 1)) * np.linspace(0.0, 1.0, w)[None, :]
    out = np.zeros((n, h, w, 1), np.float32)
    for k in range(n):
        horizon = 0.35 + 0.1 * rng.random()
        ground = np.clip((yy - horizon) / (1.0 - horizon), 0.0, 1.0) * 0.85
        disp = ground
        disp = disp + 0.02 * np.sin(2 * np.pi * (xx * rng.uniform(1, 3)
                                                 + rng.random()))
        disp = disp * (yy > horizon * 0.55)          # sky = 0
        boxes = []                                   # far first
        for _ in range(rng.integers(6, 12)):
            d = rng.uniform(0.08, 0.9)
            bw = rng.uniform(0.05, 0.25)
            bh = rng.uniform(0.1, 0.45)
            x0 = rng.uniform(0, 1 - bw)
            y0 = np.clip(horizon - bh + rng.uniform(0, 0.2), 0, 1 - bh)
            boxes.append((d, x0, y0, bw, bh))
        for d, x0, y0, bw, bh in sorted(boxes):
            sel = ((xx >= x0) & (xx < x0 + bw) & (yy >= y0)
                   & (yy < y0 + bh) & (d > disp * 0.9))
            disp = np.where(sel, d + 0.03 * (yy - y0), disp)
        for _ in range(rng.integers(2, 5)):          # thin poles
            d = rng.uniform(0.3, 0.8)
            xc = int(rng.uniform(0.05, 0.95) * w)
            wd = int(rng.integers(2, 4))
            y0 = int(horizon * h * rng.uniform(0.7, 1.0))
            disp[y0:, xc:xc + wd] = np.maximum(disp[y0:, xc:xc + wd], d)
        out[k, :, :, 0] = disp
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def haar_dwt(x: torch.Tensor):
    """(N, 2H, 2W, C) -> (ll, lh, hl, hh), each (N, H, W, C), orthonormal
    Haar in pytorch_wavelets' band order."""
    n, h2, w2, c = x.shape
    x = x.reshape(n, h2 // 2, 2, w2 // 2, 2, c)
    x00, x01 = x[:, :, 0, :, 0, :], x[:, :, 0, :, 1, :]
    x10, x11 = x[:, :, 1, :, 0, :], x[:, :, 1, :, 1, :]
    return ((x00 + x01 + x10 + x11) * 0.5, (x00 + x01 - x10 - x11) * 0.5,
            (x00 - x01 + x10 - x11) * 0.5, (x00 - x01 - x10 + x11) * 0.5)


def haar_dwt_J(x: torch.Tensor, J: int):
    """J-level Haar DWT: (yl, [level-1 (lh, hl, hh), ..., level-J]), level
    1 the finest."""
    highs, ll = [], x
    for _ in range(J):
        ll, lh, hl, hh = haar_dwt(ll)
        highs.append((lh, hl, hh))
    return ll, highs


def threshold_mask(yl: torch.Tensor, yh: torch.Tensor, ratio) -> torch.Tensor:
    """The reference's rule: max |yh| over bands > (max - min of yl, per
    image) * ratio, as a {0, 1} (N, H, W, 1) mask."""
    span = (yl.amax(dim=(1, 2, 3), keepdim=True)
            - yl.amin(dim=(1, 2, 3), keepdim=True))
    return (yh.abs().amax(dim=-1, keepdim=True) > span * ratio).to(yl.dtype)


def dwt_stage_masks(disp: np.ndarray, thresh_ratio: float,
                    scales=(1, 2, 3)) -> dict:
    """{stage i: (n, H/2^(i+1), W/2^(i+1), 1) float32 mask}: the threshold
    rule on the true DWT level i+1 of `disp`, with the J-level LL rescaled
    to scale 2^i."""
    j = max(scales) + 1
    yl, highs = haar_dwt_J(torch.from_numpy(np.asarray(disp, np.float32)),
                           J=j)
    return {i: threshold_mask(yl * (2.0 ** (i - j)),
                              torch.cat(highs[i], dim=-1),
                              thresh_ratio).numpy()
            for i in scales}


def aggregate_density(masks: dict, h: int, w: int) -> float:
    """The decoder's density over the wavelet masks that raw stage masks
    imply, plus the all-ones scale-3 mask at (h/16, w/16)."""
    num = den = (h // 16) * (w // 16)
    for i, m in masks.items():
        hw = (h // 2 ** i) * (w // 2 ** i)
        num += float(m.mean()) * hw
        den += hw
    return num / den


def masks_at_density(disp: np.ndarray, density: float = 0.10,
                     scales=(1, 2, 3), tol: float = 0.002):
    """Bisect the threshold ratio so the aggregate density hits the
    target. Returns (masks, ratio, density)."""
    h, w = disp.shape[1], disp.shape[2]
    lo, hi = 1e-4, 1.0
    masks = dwt_stage_masks(disp, hi, scales)
    for _ in range(40):
        mid = (lo * hi) ** 0.5
        masks = dwt_stage_masks(disp, mid, scales)
        d = aggregate_density(masks, h, w)
        if abs(d - density) < tol:
            return masks, mid, d
        if d > density:
            lo = mid
        else:
            hi = mid
    return masks, mid, d


def nyu_raw_masks(disp: np.ndarray, density: float = 0.05,
                  tol: float = 0.002):
    """The NYU decoder's raw masks {s: (N, h, w, 1)} at its sparse scales
    (s=1 at H/16, s=0 at H/8 of the input, from scenes at the decoder's
    output size H/2) with the threshold bisected so the base masks' density
    over both sparse scales, area-weighted as their wavelet masks (4x the
    raw area each), hits `density`. A frozen copy of chip_smoke.py's
    `nyu_raw_masks` rule. Returns (masks, ratio, density)."""

    def masks(r):     # dwt_stage_masks' stage i masks are h / 2^(i+1)
        m = dwt_stage_masks(disp, r, scales=(1, 2))
        return {1: m[2], 0: m[1]}

    def dens(m):
        a1, a0 = m[1][0].size, m[0][0].size
        return (a1 * float(m[1].mean()) + a0 * float(m[0].mean())) / (a1
                                                                      + a0)
    lo, hi = 1e-4, 1.0
    for _ in range(40):
        mid = (lo * hi) ** 0.5
        m = masks(mid)
        d = dens(m)
        if abs(d - density) < tol:
            break
        lo, hi = (mid, hi) if d > density else (lo, mid)
    return m, mid, d
