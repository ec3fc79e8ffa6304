"""Depth error metrics: the KITTI seven-metric row and the NYU variants.

Counterpart of `wavelet_monodepth_tpu/ops/metrics.py`: numpy versions for
the evaluators (`KITTI/evaluate_depth.py:50-68`, `NYUv2/utils.py:85-98`)
and `compute_errors`, the torch twin of `compute_errors_jnp` (the same row
on device tensors, `KITTI/layers.py:314-332`).
"""

from __future__ import annotations

import numpy as np
import torch


def compute_errors_np(gt: np.ndarray, pred: np.ndarray):
    """KITTI metrics over flattened valid pixels:
    (abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def compute_errors(gt: torch.Tensor, pred: torch.Tensor):
    """`compute_errors_np` on tensors: 0-dim tensors on pred's device, the
    errors in pred's dtype and a1-a3 in float32 (as `compute_errors_jnp`,
    whose boolean means are float32)."""
    thresh = torch.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).float().mean()
    a2 = (thresh < 1.25 ** 2).float().mean()
    a3 = (thresh < 1.25 ** 3).float().mean()
    rmse = torch.sqrt(((gt - pred) ** 2).mean())
    rmse_log = torch.sqrt(((torch.log(gt) - torch.log(pred)) ** 2).mean())
    abs_rel = torch.mean(torch.abs(gt - pred) / gt)
    sq_rel = torch.mean(((gt - pred) ** 2) / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def compute_errors_nyu_np(gt: np.ndarray, pred: np.ndarray):
    """NYU metrics (`NYUv2/utils.py:85-98`):
    (a1, a2, a3, abs_rel, rmse, log10)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    log10 = np.mean(np.abs(np.log10(gt) - np.log10(pred)))
    return a1, a2, a3, abs_rel, rmse, log10
