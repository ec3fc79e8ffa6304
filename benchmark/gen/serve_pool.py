"""The serving cells' request pool: seeded synthetic scenes rendered as
uint8 frames, and the raw masks the sparse decoders run under.

Scenes come from the frozen maskgen copy (`gen/maskgen.py`) on the host;
the frames are rendered on the device (shading 0.25 + 0.6 * disparity plus
N(0, 0.05) texture from a `torch.Generator` on the device, as maskgen's
`scene_image` renders them) and rounded to uint8. The masks are the
scenes' true-DWT edge masks at the cell's density, by the rule the cell's
parameters name.

Every seed serves the same set of scenes (drawn from the cell's
`scene_seed`), so every run does the same work: the run's seed draws the
order of the pool's batches and of the frames within each batch, the
frames' texture and, elsewhere, the weights. The rules:

- "kitti_stage_masks": maskgen's stage masks at scales 3, 2, 1 of scenes
  at the frame size, the threshold bisected over the whole pool to the
  aggregate density (the KITTI sparse decoder's 10% operating point).
- "nyu_raw_masks": scenes at half the frame size (the NYU decoder's
  output), masks at scales 1 and 0, the threshold bisected to the density
  of both sparse scales (the NYU 5% operating point); the frames render
  the scenes upsampled x2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import maskgen


@dataclass
class Pool:
    frames: torch.Tensor        # (P, H, W, 3) uint8 on the device
    masks: dict | None          # {scale: (P, h, w, 1) float32 numpy}
    ratio: float | None
    density: float | None


def sub_seed(seed: int, k: int) -> int:
    """A distinct 63-bit stream per purpose k of one run's seed."""
    return (int(seed) * 1_000_003 + 7_919 * k) % (2 ** 63)


def render(disp: np.ndarray, seed: int, device) -> torch.Tensor:
    d = torch.from_numpy(disp).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    tex = torch.empty(d.shape[:3] + (3,), device=device).normal_(
        0.0, 0.05, generator=gen)
    img = torch.clamp(0.25 + 0.6 * d + tex, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)


def order(n: int, batch: int, seed: int) -> np.ndarray:
    """The seed's order of a pool of n scenes in batches of `batch`: the
    batches permuted, and the frames within each."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    rows = np.arange(n).reshape(n // batch, batch)[rng.permutation(
        n // batch)]
    return np.concatenate([rng.permutation(r) for r in rows])


def make_pool(params: dict, height: int, width: int, seed: int,
              device) -> Pool:
    n = int(params["pool"])
    rule = params.get("mask_rule")
    nyu = rule == "nyu_raw_masks"
    disp = maskgen.synthetic_depth_scene(
        n, height // (1 + nyu), width // (1 + nyu), int(params["scene_seed"]))
    masks = ratio = dens = None
    if nyu:
        masks, ratio, dens = maskgen.nyu_raw_masks(disp, params["density"])
        disp = disp.repeat(2, axis=1).repeat(2, axis=2)
    elif rule == "kitti_stage_masks":
        masks, ratio, dens = maskgen.masks_at_density(disp,
                                                      params["density"])
    elif rule is not None:
        raise ValueError(f"unknown mask rule {rule!r}")
    idx = order(n, int(params["batch"]), seed)
    if masks is not None:
        masks = {s: np.ascontiguousarray(m[idx]) for s, m in masks.items()}
    return Pool(render(disp[idx], seed, device), masks, ratio, dens)
