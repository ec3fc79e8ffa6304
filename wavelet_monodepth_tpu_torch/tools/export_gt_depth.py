"""GT depths for the evaluation: the port's `KITTI/export_gt_depth.py`.

Counterpart of `wavelet_monodepth_tpu/tools/export_gt_depth.py`
(`KITTI/export_gt_depth.py:19-65`): for the eigen split, each test
frame's velodyne points projected to the left camera; for
eigen_benchmark, the improved GT's 16-bit PNGs / 256. Writes
<split dir>/gt_depths.npz: key "data", an object array of float32 maps.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.export_gt_depth \
      --data_path kitti_data --split eigen [--splits_dir splits]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from PIL import Image
    from ..data.kitti_utils import generate_depth_map
    from ..data.splits import readlines, resolve_split_dir

    p = argparse.ArgumentParser(description="export_gt_depth")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--split", type=str, required=True,
                   choices=["eigen", "eigen_benchmark"])
    p.add_argument("--splits_dir", type=str, default=None)
    args = p.parse_args(argv)

    split_folder = (os.path.join(args.splits_dir, args.split)
                    if args.splits_dir
                    else resolve_split_dir(args.split, args.data_path))
    lines = readlines(os.path.join(split_folder, "test_files.txt"))
    print(f"Exporting ground truth depths for {args.split}")

    gt_depths = []
    for line in lines:
        folder, frame_id, _ = line.split()
        frame_id = int(frame_id)
        if args.split == "eigen":
            calib_dir = os.path.join(args.data_path, folder.split("/")[0])
            velo = os.path.join(
                args.data_path, folder,
                f"velodyne_points/data/{frame_id:010d}.bin")
            gt = generate_depth_map(calib_dir, velo, 2, True)
        else:
            gt_path = os.path.join(
                args.data_path, folder, "proj_depth/groundtruth/image_02",
                f"{frame_id:010d}.png")
            gt = np.array(Image.open(gt_path)).astype(np.float32) / 256
        gt_depths.append(gt.astype(np.float32))

    out = os.path.join(split_folder, "gt_depths.npz")
    np.savez_compressed(out, data=np.array(gt_depths, dtype=object))
    print(f"Saved to {out}")


if __name__ == "__main__":
    main()
