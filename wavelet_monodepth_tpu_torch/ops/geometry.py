"""Depth/disparity conversion. Counterpart of
`wavelet_monodepth_tpu/ops/geometry.py:14-20` (`disp_to_depth` only; the
training geometry is ported with the training step)."""

from __future__ import annotations

import torch


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid output -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth
