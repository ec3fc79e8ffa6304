"""Host-side resizes with OpenCV's semantics, in numpy, so the port needs
no cv2.

The JAX package resizes on the host with `cv2.resize`: predicted
disparities to the GT size with INTER_LINEAR before scoring
(`eval/kitti_eval.py:141`, `tools/evaluate_depth.py:175-183`), and the
synthetic mount's low-frequency texture with INTER_CUBIC
(`data/synth.py:57-61`). These functions compute what OpenCV computes:

  * source position of output pixel d: (d + 0.5) * (src / dst) - 0.5, in
    float64, split into floor and fraction; first along the rows, then
    down the columns;
  * INTER_LINEAR: a lerp, s0 + (s1 - s0) * t with one rounding after the
    multiply-add (OpenCV's fused multiply-add), t the fraction in the
    array's precision; a position left of 0 or right of the last pixel
    takes the edge pixel whole. On float32 this is bit for bit OpenCV
    5.0's result (the multiply-add is exact in float64, then rounded);
    on float64 within 1e-13 relative;
  * INTER_CUBIC: Keys' kernel with A = -0.75, weights in float32, the
    four taps clamped into the image (replicate); within 1e-5 of OpenCV
    on float64.

  * INTER_AREA on uint8 where one axis is enlarged (the synthetic NYU
    zip's 1242x375 -> 640x480): OpenCV then runs its linear resampler
    with "area" taps, sx = floor(d * src / dst) and fraction
    (d + 1) - (sx + 1) * dst / src less its floor (0 where not positive),
    in 11-bit fixed point: weights round(w * 2048), a horizontal sum in
    int, then each of the two vertical products taken >> 4, times the
    weight, >> 16, summed with 2 and >> 2. Bit for bit OpenCV 5.0's
    result. A reduction on both axes is OpenCV's true area average, which
    `resize_area_u8` does not do.

INTER_NEAREST is `data/kitti.py::resize_nearest`.
"""

from __future__ import annotations

import numpy as np

_CUBIC_A = np.float32(-0.75)


def _linear_taps(dst: int, src: int, dtype):
    """(left index, right index, fraction in `dtype`) per output pixel;
    positions outside the image take the edge pixel whole."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    idx = np.floor(pos).astype(np.int64)
    frac = pos - idx
    frac[(idx < 0) | (idx >= src - 1)] = 0.0
    idx = np.clip(idx, 0, src - 1)
    return idx, np.minimum(idx + 1, src - 1), frac.astype(dtype)


def _lerp(s0: np.ndarray, s1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """fma(s1 - s0, t, s0), rounded once to s0's dtype: float32 products
    are exact in float64."""
    if s0.dtype == np.float64:
        return (s1 - s0) * t + s0
    return ((s1 - s0).astype(np.float64) * t + s0).astype(s0.dtype)


def _cubic_taps(dst: int, src: int):
    """(4 indices, 4 float32 weights) per output pixel, indices clamped."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    idx = np.floor(pos).astype(np.int64)
    x = (pos - idx).astype(np.float32)
    a = _CUBIC_A
    one = np.float32(1.0)
    w0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    w1 = ((a + 2) * x - (a + 3)) * x * x + one
    w2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    w3 = one - w0 - w1 - w2
    taps = np.clip(idx[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return taps, np.stack([w0, w1, w2, w3], axis=1)


def _float(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype not in (np.float32, np.float64):
        raise TypeError(f"resize of a {a.dtype} array: only float32 and "
                        "float64 are supported")
    return a


def resize_linear(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(a, (width, height))` (INTER_LINEAR) of a float32 or
    float64 (H, W) or (H, W, C) array."""
    a = _float(a)
    h, w = a.shape[:2]
    extra = (1,) * (a.ndim - 2)
    x0, x1, fx = _linear_taps(width, w, a.dtype)
    rows = _lerp(a[:, x0], a[:, x1], fx.reshape((1, width) + extra))
    y0, y1, fy = _linear_taps(height, h, a.dtype)
    return _lerp(rows[y0], rows[y1], fy.reshape((height, 1) + extra))


def resize_cubic(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(a, (width, height), interpolation=cv2.INTER_CUBIC)` of
    a float32 or float64 (H, W) or (H, W, C) array: rows first, then
    columns, the four taps summed in order in a's dtype."""
    a = _float(a)
    h, w = a.shape[:2]
    extra = (1,) * (a.ndim - 2)
    xt, xw = _cubic_taps(width, w)
    xw = xw.astype(a.dtype).reshape((1, width, 4) + extra)
    rows = xw[:, :, 0] * a[:, xt[:, 0]]
    for k in range(1, 4):
        rows = rows + xw[:, :, k] * a[:, xt[:, k]]
    yt, yw = _cubic_taps(height, h)
    yw = yw.astype(a.dtype).reshape((height, 1, 4) + extra)
    out = yw[:, :, 0] * rows[yt[:, 0]]
    for k in range(1, 4):
        out = out + yw[:, :, k] * rows[yt[:, k]]
    return out


def _area_taps(dst: int, src: int):
    """(left index, right index, left weight, right weight) per output
    pixel of OpenCV's area-mode linear taps, weights in 1/2048ths."""
    d = np.arange(dst)
    sx = np.floor(d * (src / dst)).astype(np.int64)
    fx = ((d + 1) - (sx + 1) * (dst / src)).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    w1 = np.round(fx * np.float32(2048)).astype(np.int64)
    w0 = np.round((np.float32(1) - fx) * np.float32(2048)).astype(np.int64)
    return (np.clip(sx, 0, src - 1), np.clip(sx + 1, 0, src - 1), w0, w1)


def resize_area_u8(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(a, (width, height), interpolation=cv2.INTER_AREA)` of a
    uint8 (H, W) or (H, W, C) array that is enlarged on at least one
    axis (see the module docstring)."""
    a = np.asarray(a)
    h, w = a.shape[:2]
    if a.dtype != np.uint8:
        raise TypeError(f"resize_area_u8 of a {a.dtype} array")
    if width <= w and height <= h:
        raise ValueError("resize_area_u8 does not do OpenCV's area average "
                         "(a reduction on both axes)")
    extra = (1,) * (a.ndim - 2)
    x0, x1, a0, a1 = _area_taps(width, w)
    s = a.astype(np.int64)
    rows = (s[:, x0] * a0.reshape((1, width) + extra)
            + s[:, x1] * a1.reshape((1, width) + extra))
    y0, y1, b0, b1 = _area_taps(height, h)
    b0 = b0.reshape((height, 1) + extra)
    b1 = b1.reshape((height, 1) + extra)
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
