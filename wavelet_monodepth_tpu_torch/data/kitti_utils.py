"""KITTI calibration and velodyne ground truth on the host, in numpy.

Counterpart of `wavelet_monodepth_tpu/data/kitti_utils.py`
(`KITTI/kitti_utils.py:14-104`): raw calibration parsing, velodyne point
loading, and the velodyne-to-camera projection that gives the sparse GT
depth maps of the eigen split. Where two points land on one pixel the
smaller depth wins, as in the KITTI devkit that the reference follows.
"""

from __future__ import annotations

import os

import numpy as np


def load_velodyne_points(filename: str) -> np.ndarray:
    """(N, 4) float32 points of a velodyne .bin, reflectance set to 1."""
    pts = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def read_calib_file(path: str) -> dict:
    """{key: float64 array} of a KITTI calib file; a value that is not a
    list of numbers stays a string."""
    data = {}
    with open(path) as f:
        for line in f:
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                data[key] = value
    return data


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Sparse float64 depth map in the rectified frame of camera `cam`,
    of the calibration's S_rect_02 size; 0 where no point lands.
    vel_depth: the velodyne x instead of the camera depth."""
    cam2cam = read_calib_file(os.path.join(calib_dir,
                                           "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(os.path.join(calib_dir,
                                                "calib_velo_to_cam.txt"))
    velo2cam = np.eye(4)
    velo2cam[:3, :3] = velo2cam_raw["R"].reshape(3, 3)
    velo2cam[:3, 3] = velo2cam_raw["T"]

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)

    r_rect = np.eye(4)
    r_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    p_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    p_velo2im = p_rect @ r_rect @ velo2cam

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0]

    pts_im = (p_velo2im @ velo.T).T
    pts_im[:, :2] /= pts_im[:, 2:3]
    if vel_depth:
        pts_im[:, 2] = velo[:, 0]

    # round minus one: the KITTI matlab devkit's indexing
    pts_im[:, 0] = np.round(pts_im[:, 0]) - 1
    pts_im[:, 1] = np.round(pts_im[:, 1]) - 1
    valid = ((pts_im[:, 0] >= 0) & (pts_im[:, 1] >= 0)
             & (pts_im[:, 0] < im_shape[1]) & (pts_im[:, 1] < im_shape[0]))
    pts_im = pts_im[valid]

    depth = np.full(tuple(im_shape[:2]), np.inf)
    np.minimum.at(depth, (pts_im[:, 1].astype(np.int64),
                          pts_im[:, 0].astype(np.int64)), pts_im[:, 2])
    depth[np.isinf(depth)] = 0
    depth[depth < 0] = 0
    return depth
