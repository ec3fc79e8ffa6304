"""Edge-structured wavelet masks from synthetic depth scenes: the sparse
decoder's ~10% coefficient-density operating point without a trained
checkpoint.

Counterpart of `wavelet_monodepth_tpu/utils/maskgen.py`. A trained
decoder's yh at scale s approximates the true Haar DWT of the disparity,
so the masks of an ideally trained model are the thresholded true DWT
coefficients of the predicted depth. Scenes are piecewise-smooth
KITTI-like disparity maps (ground plane, occluding boxes, thin poles);
their Haar DWT is thresholded with the reference's rule at a ratio
bisected to hit a target aggregate density. numpy, plus the port's own
wavelets and threshold (on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sparse import wavelet_threshold_mask
from ..ops.wavelets import haar_dwt_J


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


def scene_image(disp: np.ndarray, seed: int = 0) -> np.ndarray:
    """A textured (n, h, w, 3) rendering of the scene (shading + noise)."""
    rng = np.random.default_rng(seed)
    n, h, w, _ = disp.shape
    base = 0.25 + 0.6 * disp
    tex = rng.normal(0.0, 0.05, (n, h, w, 3)).astype(np.float32)
    return np.clip(base + tex, 0.0, 1.0).astype(np.float32)


def dwt_stage_masks(disp: np.ndarray, thresh_ratio: float,
                    scales=(1, 2, 3)) -> dict:
    """{stage i: (n, H/2^(i+1), W/2^(i+1), 1) float32 mask}: the
    reference's threshold rule on the TRUE DWT level i+1 of `disp`, with
    the J-level LL rescaled to scale 2^i."""
    j = max(scales) + 1
    yl, highs = haar_dwt_J(torch.from_numpy(np.asarray(disp, np.float32)),
                           J=j)
    masks = {}
    for i in scales:
        yh = torch.cat(highs[i], dim=-1)          # DWT level i+1
        masks[i] = wavelet_threshold_mask(yl * (2.0 ** (i - j)), yh,
                                          thresh_ratio).numpy()
    return masks


def aggregate_density(masks: dict, h: int, w: int) -> float:
    """compute_density's aggregation over the wavelet masks implied by raw
    stage masks, plus the all-ones scale-3 mask at (h/16, w/16)."""
    num = (h // 16) * (w // 16)
    den = (h // 16) * (w // 16)
    for i, m in masks.items():
        hw = (h // 2 ** i) * (w // 2 ** i)
        num += float(m.mean()) * hw
        den += hw
    return num / den


def masks_at_density(disp: np.ndarray, density: float = 0.10,
                     scales=(1, 2, 3), tol: float = 0.002):
    """Bisect the threshold ratio so the aggregate density hits the
    target. Returns (masks, ratio, actual_density)."""
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
