"""The training cell's batches, made on the device in the layout that
`data/kitti.py` (device_augment=True) and `data/loader.to_device` give:

    ("color_u8", "0", s)  uint8 (B, H/2^s, W/2^s, 3), s = 0..3
    ("color_u8", "s", 0)  uint8 (B, H, W, 3), the stereo frame
    ("jitter",)           (B, 4): brightness, contrast, saturation, hue
                          (U(0.8, 1.2) x 3 and U(-0.1, 0.1) for half of
                          the items, identity (1, 1, 1, 0) for the rest)
    ("K", s), ("inv_K", s)  (B, 4, 4): the KITTI normalised intrinsics at
                          each scale, and their inverse
    ("stereo_T",)         (B, 4, 4): identity with x-translation +-0.1
    ("depth_hint",), ("depth_hint_mask",), ("disp_hint",)  (B, H, W, 1)

Scenes are maskgen's (`gen/maskgen.py`): the target frame renders the
scene, the stereo frame is the target resampled along each row by the
scene's disparity (up to ~12 px), lower scales are area averages, and the
depth hint is the scene's depth (1 / (0.02 + 0.3 disparity)) with 10% of
its pixels and the sky marked invalid. The automask noise is N(0, 1) per
loss scale at full size. Every tensor is drawn from the seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import maskgen
from .serve_pool import render, sub_seed

K_NORM = ((0.58, 0, 0.5, 0), (0, 1.92, 0.5, 0), (0, 0, 1, 0), (0, 0, 0, 1))


def make_batches(params: dict, height: int, width: int, seed: int, device
                 ) -> tuple:
    """([batch dict] * pool, [{scale: noise}] * pool)."""
    b, n = int(params["batch"]), int(params["pool"])
    scales = tuple(params["scales"])
    disp = maskgen.synthetic_depth_scene(n * b, height, width,
                                         sub_seed(seed, 0))
    img = render(disp, seed, device).float() / 255.0      # (nB, H, W, 3)
    d = torch.from_numpy(disp).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2))

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)
    # the stereo frame: each row resampled by the disparity (in px)
    shift = 14.0 * d[..., 0]
    xs = torch.arange(width, device=device, dtype=torch.float32)
    gx = (xs[None, None, :] - shift + 0.5) / width * 2 - 1
    gy = ((torch.arange(height, device=device, dtype=torch.float32) + 0.5)
          / height * 2 - 1)[None, :, None].expand_as(gx)
    other = F.grid_sample(img.permute(0, 3, 1, 2),
                          torch.stack([gx, gy], -1), mode="bilinear",
                          padding_mode="border", align_corners=False)
    target = img.permute(0, 3, 1, 2)
    depth = 1.0 / (0.02 + 0.3 * d)
    valid = ((d > 0) & (u(n * b, height, width, 1) > 0.1)).float()
    aug = u(n * b) < 0.5
    jit = torch.stack([0.8 + 0.4 * u(n * b), 0.8 + 0.4 * u(n * b),
                       0.8 + 0.4 * u(n * b), 0.2 * u(n * b) - 0.1], 1)
    jit = torch.where(aug[:, None], jit,
                      torch.tensor([1.0, 1.0, 1.0, 0.0], device=device))
    sign = torch.where(u(n * b) < 0.5, -1.0, 1.0)
    stereo = torch.eye(4, device=device).repeat(n * b, 1, 1)
    stereo[:, 0, 3] = 0.1 * sign
    u8 = lambda t: torch.round(t.clamp(0, 1) * 255).to(torch.uint8)  # noqa
    full = {("color_u8", "s", 0): u8(other.permute(0, 2, 3, 1)),
            ("jitter",): jit, ("stereo_T",): stereo,
            ("depth_hint",): depth * valid, ("depth_hint_mask",): valid,
            ("disp_hint",): d * valid}
    for s in scales:
        t = target if s == 0 else F.avg_pool2d(target, 2 ** s)
        full[("color_u8", "0", s)] = u8(t.permute(0, 2, 3, 1))
        k = torch.tensor(K_NORM, device=device)
        k[0, :] *= width // 2 ** s
        k[1, :] *= height // 2 ** s
        full[("K", s)] = k.expand(n * b, 4, 4).contiguous()
        full[("inv_K", s)] = torch.linalg.pinv(k).expand(n * b, 4, 4
                                                          ).contiguous()
    batches = [{key: v[i * b:(i + 1) * b].contiguous()
                for key, v in full.items()} for i in range(n)]
    noise = torch.randn((n, len(scales), b, height, width, 1),
                        generator=gen, device=device)
    noises = [{s: noise[i, j] for j, s in enumerate(scales)}
              for i in range(n)]
    return batches, noises
