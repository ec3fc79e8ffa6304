"""KITTI odometry evaluation: the 5-frame-track ATE.

Counterpart of `wavelet_monodepth_tpu/eval/pose_eval.py`
(`KITTI/evaluate_pose.py:23-134`, SfMLearner's protocol): predict the
relative pose of each consecutive frame pair of odometry sequence 09 or
10, chain them into 5-frame tracks, align each track's scale to the
ground truth's and report the RMSE. The trajectory arithmetic is the
JAX package's numpy, line for line (float64); `predict_poses` runs the
pose net on torch tensors.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ..ops.geometry import transformation_from_parameters


def dump_xyz(rel_transforms) -> list[np.ndarray]:
    """Chain source->target transforms into camera positions."""
    xyzs = []
    cam_to_world = np.eye(4)
    xyzs.append(cam_to_world[:3, 3].copy())
    for t in rel_transforms:
        cam_to_world = cam_to_world @ t
        xyzs.append(cam_to_world[:3, 3].copy())
    return xyzs


def compute_ate(gtruth_xyz: np.ndarray, pred_xyz_o: np.ndarray) -> float:
    """Scale-aligned absolute trajectory error over one track."""
    offset = gtruth_xyz[0] - pred_xyz_o[0]
    pred_xyz = pred_xyz_o + offset[None, :]
    scale = np.sum(gtruth_xyz * pred_xyz) / np.sum(pred_xyz ** 2)
    err = pred_xyz * scale - gtruth_xyz
    return float(np.sqrt(np.sum(err ** 2)) / gtruth_xyz.shape[0])


def local_gt_poses(gt_global_poses: np.ndarray) -> list[np.ndarray]:
    """A KITTI odometry poses file (N, 3, 4) -> the relative local poses
    (`evaluate_pose.py:104-114`)."""
    g = np.concatenate(
        [gt_global_poses, np.zeros((gt_global_poses.shape[0], 1, 4))], 1)
    g[:, 3, 3] = 1
    return [np.linalg.inv(np.linalg.inv(g[i - 1]) @ g[i])
            for i in range(1, len(g))]


def evaluate_trajectory(pred_poses: np.ndarray,
                        gt_global_poses: np.ndarray,
                        track_length: int = 5):
    """(mean ATE, std ATE) over every track of `track_length` frames."""
    gt_local = local_gt_poses(gt_global_poses)
    gt_xyzs = gt_global_poses[:, :3, 3]
    ates = []
    for i in range(gt_xyzs.shape[0] - 1):
        local_xyzs = np.array(dump_xyz(pred_poses[i:i + track_length - 1]))
        gt_local_xyzs = np.array(dump_xyz(gt_local[i:i + track_length - 1]))
        ates.append(compute_ate(gt_local_xyzs, local_xyzs))
    return float(np.mean(ates)), float(np.std(ates))


def predict_poses(pose_forward: Callable, frame_pairs: Iterable[np.ndarray],
                  device) -> np.ndarray:
    """Run `pose_forward` ((N, H, W, 6) float32 tensor on `device` ->
    (axisangle, translation)) over stacked frame pairs ((H, W, 6) or
    (N, H, W, 6) arrays); returns the (N, 4, 4) float32 relative
    transforms (`evaluate_pose.py:89-102`)."""
    preds = []
    with torch.inference_mode():
        for pair in frame_pairs:
            if pair.ndim == 3:
                pair = pair[None]
            aa, tr = pose_forward(torch.from_numpy(np.ascontiguousarray(
                pair, np.float32)).to(device))
            t = transformation_from_parameters(aa[:, 0], tr[:, 0])
            preds.append(t.float().cpu().numpy())
    return np.concatenate(preds, axis=0)
