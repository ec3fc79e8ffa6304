"""Colour jitter on the device, and the uint8 feeds' expansion.

Counterpart of `wavelet_monodepth_tpu/ops/augment.py` (`color_jitter`,
`expand_batch`, `expand_nyu`) on torch tensors. The KITTI train feed
ships uint8 frames and four jitter factors per item (`data/kitti.py`
with device_augment=True); `expand_batch` casts the frames to float and
synthesises the scale-0 `color_aug` on the card, which is where the step
reads it. The NYU feed ships uint8 images and depths (`data/nyu.py`
with uint8_feed=True), which `expand_nyu` casts and clamps on the card.

Semantics are PIL's enhance chain (brightness -> contrast -> saturation ->
hue, `mono_dataset.py:98-104`) in float: each blend clips to [0, 1]
without PIL's uint8 rounding, and hue rotates float HSV by hue * 255/256
of a turn (PIL adds int(hue * 255) to its 8-bit H channel).
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

# luminance weights of PIL's L mode (ITU-R 601-2)
_LUMA = (0.299, 0.587, 0.114)


def _luma(x: Tensor) -> Tensor:
    return _LUMA[0] * x[..., 0] + _LUMA[1] * x[..., 1] + _LUMA[2] * x[..., 2]


def _rgb_to_hsv(r: Tensor, g: Tensor, b: Tensor):
    mx = torch.maximum(r, torch.maximum(g, b))
    mn = torch.minimum(r, torch.minimum(g, b))
    d = mx - mn
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(mx == r, ((g - b) / safe_d) % 6.0,
                    torch.where(mx == g, (b - r) / safe_d + 2.0,
                                (r - g) / safe_d + 4.0))
    h = torch.where(d == 0, torch.zeros_like(h), h) / 6.0
    s = torch.where(mx == 0, torch.zeros_like(d),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return h, s, mx


def _hsv_to_rgb(h: Tensor, s: Tensor, v: Tensor):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.to(torch.int32) % 6

    def pick(*vals):            # vals[k] where i == k
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), \
        pick(p, p, t, v, v, q)


def color_jitter(img: Tensor, brightness, contrast, saturation,
                 hue) -> Tensor:
    """Jitter float [0, 1] RGB images (..., H, W, 3). The factors are
    scalars or tensors broadcastable over the leading dims: (N, 1, 1, 1)
    gives per-item factors for an NHWC batch. Identity is (1, 1, 1, 0)."""
    img = img.float()
    as_t = (lambda v: torch.as_tensor(v, dtype=torch.float32,
                                      device=img.device))
    b, c, s, h = (as_t(v) for v in (brightness, contrast, saturation, hue))
    x = torch.clamp(img * b, 0.0, 1.0)
    # ImageEnhance.Contrast blends with the image's own mean luminance
    mean = _luma(x).mean(dim=(-2, -1), keepdim=True)[..., None]
    x = torch.clamp(mean + (x - mean) * c, 0.0, 1.0)
    luma = _luma(x)[..., None]
    x = torch.clamp(luma + (x - luma) * s, 0.0, 1.0)
    if h.dim() == img.dim():        # per-item (N, 1, 1, 1) -> (N, 1, 1)
        h = h[..., 0]
    hh, ss, vv = _rgb_to_hsv(x[..., 0], x[..., 1], x[..., 2])
    hh = (hh + h * (255.0 / 256.0)) % 1.0
    r, g, bl = _hsv_to_rgb(hh, ss, vv)
    return torch.clamp(torch.stack([r, g, bl], dim=-1), 0.0, 1.0)


def expand_batch(inputs: dict) -> dict:
    """Batches of `KittiRawDataset(device_augment=True)`: ("color_u8",
    fid, s) uint8 frames become ("color", fid, s) float [0, 1], and
    ("color_aug", fid, 0) is made from the per-item ("jitter",) factors.
    Float batches pass through unchanged."""
    if not any(k[0] == "color_u8" for k in inputs):
        return inputs
    out = {k: v for k, v in inputs.items()
           if k[0] not in ("color_u8", "jitter")}
    for k, v in inputs.items():
        if k[0] == "color_u8":
            out[("color", k[1], k[2])] = v.float() / 255.0
    jit = inputs.get(("jitter",))
    for fid in sorted({k[1] for k in inputs if k[0] == "color_u8"}):
        color0 = out[("color", fid, 0)]
        if jit is None:
            out[("color_aug", fid, 0)] = color0
        else:
            p = jit.float()[:, :, None, None, None]          # (N, 4, 1,1,1)
            out[("color_aug", fid, 0)] = color_jitter(
                color0, p[:, 0], p[:, 1], p[:, 2], p[:, 3])
    return out


def expand_nyu(image: Tensor, depth: Optional[Tensor] = None):
    """NYU uint8-feed batches (`data/nyu.NyuDepthDataset(uint8_feed=True)`):
    a uint8 image becomes float32 / 255; a uint8 depth gets the train
    transform's centimetre clamp clip(d / 255 * 1000, 10, 1000), in the
    host float path's order of operations, so both feeds give the same
    bits. Float inputs pass through unchanged. Returns the image alone
    when `depth` is None (the eval step's signature)."""
    if image.dtype == torch.uint8:
        image = image.to(torch.float32) / 255.0
    if depth is None:
        return image
    if depth.dtype == torch.uint8:
        depth = torch.clamp(depth.to(torch.float32) / 255.0 * 1000.0,
                            10.0, 1000.0)
    return image, depth
