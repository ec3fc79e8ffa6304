"""KITTI eigen-split depth evaluation.

Counterpart of `wavelet_monodepth_tpu/eval/kitti_eval.py`
(`KITTI/evaluate_depth.py:37-328`): disparities from the model (dense,
with the optional flip post-process, or sparse with per-image densities
and op counts), then the scoring loop on the host: resize to the GT size
(OpenCV's bilinear, `ops/resize.py`), 1 / disp, the eigen crop, x5.4
stereo scaling or per-image median scaling, the clamp to [1e-3, 80] and
the seven-metric row.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..ops.geometry import disp_to_depth
from ..ops.metrics import compute_errors_np
from ..ops.resize import resize_linear
from ..ops.sparse import compute_density

MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0
STEREO_SCALE_FACTOR = 5.4   # the 0.1 nominal baseline against KITTI's 0.54 m


def batch_post_process_disparity(l_disp: np.ndarray,
                                 r_disp: np.ndarray) -> np.ndarray:
    """Monodepth v1's flip fusion (`evaluate_depth.py:71-79`); float64."""
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    l_grid, _ = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    l_mask = (1.0 - np.clip(20 * (l_grid - 0.05), 0, 1))[None, ...]
    r_mask = l_mask[:, :, ::-1]
    return (r_mask * l_disp + l_mask * r_disp
            + (1.0 - l_mask - r_mask) * m_disp)


def _scaled_disp(out: dict, min_depth: float, max_depth: float):
    d, _ = disp_to_depth(out[("disp", 0)], min_depth, max_depth)
    return d[..., 0].float().cpu().numpy()


def _host(t: torch.Tensor) -> list:
    return t.float().cpu().numpy().ravel().tolist()


def predict_disps(forward: Callable, images: Iterable[np.ndarray], *,
                  device, min_depth: float = 0.1, max_depth: float = 100.0,
                  post_process: bool = False,
                  sparse_threshold: Optional[float] = None,
                  collect_coeffs: bool = False):
    """Run the model over eval batches: numpy NHWC uint8 (scaled by the
    forward on the card) or float in [0, 1], moved to `device`.

    forward(image batch, thresh or None) -> the decoder's output dict.
    Returns (pred_disps (N, H, W) numpy, info): info holds the per-image
    total_ops / density means in sparse mode and, with collect_coeffs,
    {scale: (N, 4, h, w) LL/LH/HL/HH stacks of each batch's first image}
    (the `--save_pred_disps --use_wavelets` output,
    `evaluate_depth.py:197-235`). Sparse mode is the reference's double
    forward (`evaluate_depth.py:173-188`): thresholds and op counts are
    per image, so a batch equals its images one by one; the flipped
    second forward runs, and its ops count, only under post_process, as
    in the JAX package.
    """
    disps = []
    total_ops = []
    densities = []
    coeffs = {s: [] for s in range(4)} if collect_coeffs else None
    for img in images:
        if img.ndim == 3:
            img = img[None]
        x = torch.from_numpy(np.ascontiguousarray(
            img if img.dtype == np.uint8 else img.astype(np.float32, copy=False)
        )).to(device)
        if sparse_threshold is not None:
            out = forward(x, sparse_threshold)
            d = _scaled_disp(out, min_depth, max_depth)
            total_ops.extend(_host(out[("total_ops", -1)]))
            densities.extend(_host(compute_density(out, per_image=True)))
            if post_process:
                out_f = forward(torch.flip(x, dims=(2,)), sparse_threshold)
                df = _scaled_disp(out_f, min_depth, max_depth)
                total_ops.extend(_host(out_f[("total_ops", -1)]))
                d = batch_post_process_disparity(d, df[:, :, ::-1])
        else:
            if post_process:
                x = torch.cat([x, torch.flip(x, dims=(2,))], dim=0)
            out = forward(x, None)
            d = _scaled_disp(out, min_depth, max_depth)
            if post_process:
                n = d.shape[0] // 2
                d = batch_post_process_disparity(d[:n], d[n:, :, ::-1])
        if coeffs is not None:
            for s in range(4):
                if out.get(("wavelets", s, "LL")) is not None:
                    coeffs[s].append(np.stack([
                        out[("wavelets", s, c)][0, :, :, 0].float().cpu()
                        .numpy() for c in ("LL", "LH", "HL", "HH")]))
        disps.append(d)
    info = {}
    if coeffs is not None:
        info["coeffs"] = {s: np.stack(v) for s, v in coeffs.items() if v}
    if total_ops:
        info["total_ops_mean"] = float(np.mean(total_ops))
        info["density_mean"] = float(np.mean(densities))
    return np.concatenate(disps, axis=0), info


def eigen_crop_mask(gt_depth: np.ndarray) -> np.ndarray:
    """Garg/eigen crop of the valid GT (`evaluate_depth.py:283-290`)."""
    gt_height, gt_width = gt_depth.shape[:2]
    mask = np.logical_and(gt_depth > MIN_DEPTH, gt_depth < MAX_DEPTH)
    crop = np.array([0.40810811 * gt_height, 0.99189189 * gt_height,
                     0.03594771 * gt_width, 0.96405229 * gt_width]
                    ).astype(np.int32)
    crop_mask = np.zeros(mask.shape)
    crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
    return np.logical_and(mask, crop_mask)


def evaluate_disps(pred_disps: np.ndarray, gt_depths,
                   eval_split: str = "eigen",
                   eval_stereo: Optional[bool] = None,
                   disable_median_scaling: Optional[bool] = None,
                   pred_depth_scale_factor: Optional[float] = None):
    """Score predicted disparities against GT depth maps
    (`evaluate_depth.py:258-317`). Returns (mean_errors[7], ratios).

    eval_stereo is required, as the reference's --eval_mono/--eval_stereo
    check (`evaluate_depth.py:88-89`): True scales by 5.4 without median
    scaling, False median-scales each image."""
    if eval_stereo is None:
        raise ValueError("choose mono or stereo evaluation: pass "
                         "eval_stereo=True (x5.4 scaling, no median "
                         "scaling) or eval_stereo=False (median "
                         "scaling)")
    if eval_stereo:
        disable_median_scaling = True
        pred_depth_scale_factor = STEREO_SCALE_FACTOR
    else:
        disable_median_scaling = bool(disable_median_scaling)
        pred_depth_scale_factor = (1.0 if pred_depth_scale_factor is None
                                   else pred_depth_scale_factor)

    errors = []
    ratios = []
    for i in range(pred_disps.shape[0]):
        gt_depth = np.asarray(gt_depths[i])
        gt_h, gt_w = gt_depth.shape[:2]
        pred_depth = 1.0 / resize_linear(pred_disps[i], gt_w, gt_h)
        if eval_split == "eigen":
            mask = eigen_crop_mask(gt_depth)
        else:
            mask = gt_depth > 0

        pred_depth = pred_depth[mask]
        gt = gt_depth[mask]
        pred_depth *= pred_depth_scale_factor
        if not disable_median_scaling:
            ratio = np.median(gt) / np.median(pred_depth)
            ratios.append(ratio)
            pred_depth *= ratio
        pred_depth = np.clip(pred_depth, MIN_DEPTH, MAX_DEPTH)
        errors.append(compute_errors_np(gt, pred_depth))

    return np.array(errors).mean(0), np.array(ratios)


def format_result_table(mean_errors) -> str:
    """`evaluate_depth.py:316-317`."""
    header = ("{:>8} | " * 7).format("abs_rel", "sq_rel", "rmse",
                                     "rmse_log", "a1", "a2", "a3")
    row = ("&{: 8.4f}  " * 7).format(*list(mean_errors)) + "\\\\"
    return "\n  " + header + "\n" + row
