"""KITTI odometry evaluation CLI: the port's `KITTI/evaluate_pose.py`.

Counterpart of `wavelet_monodepth_tpu/tools/evaluate_pose.py`, with its
flags plus --device: the 5-frame-track ATE of a two-frame pose network
(a ResNet over stacked pairs + PoseDecoder) on odometry sequence 09 or
10. Weights: --torch_model_path, a reference folder's pose_encoder.pth /
pose.pth, or --load_weights_folder, a checkpoint folder of the port's
KITTI trainer (the same files), where the predictions are saved as
poses.npy; with neither, the seeded fresh init. Runs on --device (cuda,
which raises without a card, or cpu).

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.evaluate_pose \\
      --data_path kitti_odom --eval_split odom_9 \\
      --load_weights_folder ckpt/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate_pose")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--eval_split", choices=["odom_9", "odom_10"],
                   required=True)
    p.add_argument("--load_weights_folder", type=str, default=None)
    p.add_argument("--torch_model_path", type=str, default=None)
    p.add_argument("--num_layers", type=int, default=18)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--splits_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without a card) or cpu")
    return p.parse_args(argv)


def load_pose_forward(args, device):
    """pose_forward((N, H, W, 6) float tensor on `device`) -> (axisangle,
    translation), the pose encoder in eval mode."""
    import torch
    from ..models.layers import init_params
    from ..models.pose import PoseDecoder
    from ..models.resnet import ResnetEncoder, num_ch_enc
    from . import torch_import as ti

    enc = ResnetEncoder(num_layers=args.num_layers, num_input_images=2)
    dec = PoseDecoder(num_ch_enc=num_ch_enc(args.num_layers),
                      num_input_features=1, num_frames_to_predict_for=2)
    folder = args.torch_model_path or args.load_weights_folder
    if folder:
        ti.load_state_dicts(enc, dec, *ti.load_pose_checkpoint(folder))
    else:
        gen = torch.Generator().manual_seed(0)
        init_params(enc, gen)
        init_params(dec, gen)
    enc.to(device).eval()
    dec.to(device).eval()

    def pose_forward(pair):
        return dec([enc(pair)])
    return pose_forward


def main(argv=None) -> dict:
    """Returns {"ate_mean", "ate_std", "poses"}."""
    from ..data.kitti import KittiRawDataset
    from ..data.splits import readlines, resolve_split_dir
    from ..eval import pose_eval
    from ..utils import device as device_rule

    args = parse_args(argv)
    device = device_rule.resolve_device(args.device)
    device_rule.pin_float32(device)
    seq = int(args.eval_split.split("_")[1])
    odom_dir = (os.path.join(args.splits_dir, "odom") if args.splits_dir
                else resolve_split_dir("odom", args.data_path))
    files = readlines(os.path.join(odom_dir, f"test_files_{seq:02d}.txt"))
    pose_forward = load_pose_forward(args, device)
    ds = KittiRawDataset(args.data_path, files, args.height, args.width,
                         [0, 1], target_scales=[0], is_train=False,
                         dataset="kitti_odom", img_ext=".png")

    def pairs():
        for i in range(len(ds)):
            item = ds[i]
            yield np.concatenate([item[("color_aug", "0", 0)],
                                  item[("color_aug", "1", 0)]], axis=-1)

    print("-> Computing pose predictions")
    pred_poses = pose_eval.predict_poses(pose_forward, pairs(), device)
    gt = np.loadtxt(os.path.join(args.data_path, "poses",
                                 f"{seq:02d}.txt")).reshape(-1, 3, 4)
    mean_ate, std_ate = pose_eval.evaluate_trajectory(pred_poses, gt)
    print(f"\n   Trajectory error: {mean_ate:0.3f}, std: {std_ate:0.3f}\n")
    if args.load_weights_folder:
        out = os.path.join(args.load_weights_folder, "poses.npy")
        np.save(out, pred_poses)
        print(f"-> Predictions saved to {out}")
    return {"ate_mean": mean_ate, "ate_std": std_ate, "poses": pred_poses}


if __name__ == "__main__":
    main()
