"""Depth-hint precompute: the port's `KITTI/precompute_depth_hints.py`
("fused SGM" of the Depth Hints paper).

Counterpart of `wavelet_monodepth_tpu/tools/precompute_depth_hints.py`,
with its flags and defaults (1024x320) plus --device. For every training
frame: 12 OpenCV StereoSGBM matchers (4 disparity ranges x 3 block
sizes) on the host turn the stereo pair into 12 candidate depth maps
(the normalised focal and the 0.1 nominal baseline); `fuse_depths` then
picks per pixel the candidate whose stereo reprojection (backproject ->
project into the other view -> border-clamped bilinear sample ->
0.85 SSIM + 0.15 L1) has the lowest loss, in torch on --device (cuda,
which raises without a card, or cpu). The sample is `F.grid_sample`
(`ops/image.grid_sample_border`), as JAX's fusion takes its gather.
Saves one (1, H, W) float32 .npy per frame under
<save_path>/<folder>/image_0{2,3}/.

OpenCV is imported inside the functions that need it (the matchers and
the image loading), so the module imports without it; those raise a
plain ImportError where it is missing.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.precompute_depth_hints \\
      --data_path kitti_data --filenames splits/eigen_full/train_files.txt \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

K_NORM = np.array([[0.58, 0, 0.5, 0],
                   [0, 1.92, 0.5, 0],
                   [0, 0, 1, 0],
                   [0, 0, 0, 1]], dtype=np.float32)
BASELINE = 0.1


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "precompute_depth_hints needs OpenCV (cv2) on the host for its "
            "StereoSGBM matchers and image loading; install opencv-python "
            "where the tool runs") from e
    return cv2


def generate_stereo_matchers():
    """The 12 SGBM configurations (`precompute_depth_hints.py:42-63`)."""
    cv2 = _cv2()
    matchers = []
    for block_size in (1, 2, 3):
        for num_disparity in (64, 96, 128, 160):
            sad = 3
            matchers.append(cv2.StereoSGBM_create(
                preFilterCap=63, P1=sad * sad * 4, P2=sad * sad * 32,
                minDisparity=0, numDisparities=num_disparity,
                uniquenessRatio=10, speckleWindowSize=100,
                speckleRange=16, blockSize=block_size))
    return matchers


def compute_depths(matchers, base_image, lookup_image, width,
                   reverse=False) -> np.ndarray:
    """12 SGBM disparity maps -> depths (12, H, W), 0 where a matcher found
    no disparity (`precompute_depth_hints.py:127-151`)."""
    cv2 = _cv2()
    if reverse:
        base_image = base_image[:, ::-1]
        lookup_image = lookup_image[:, ::-1]
    gray_b = cv2.cvtColor(base_image, cv2.COLOR_RGB2GRAY)
    gray_l = cv2.cvtColor(lookup_image, cv2.COLOR_RGB2GRAY)
    disps = []
    for m in matchers:
        disp = m.compute(gray_b, gray_l).astype(np.float32) / 16.0
        if reverse:
            disp = disp[:, ::-1]
        disps.append(disp)
    disps = np.stack(disps)
    focal = K_NORM[0, 0] * width
    depths = focal * BASELINE / (disps + 1e-7) * (disps > 0)
    return depths.astype(np.float32)


def fusion_losses(depths: torch.Tensor, base_image: torch.Tensor,
                  lookup_image: torch.Tensor, baseline_sign: int
                  ) -> torch.Tensor:
    """The reprojection loss of each candidate: depths (n, H, W) float32,
    the two views (H, W, 3) uint8 or float in [0, 255], on one device ->
    (n, H, W) losses (0.85 SSIM + 0.15 L1 of the lookup view warped into
    the base view by that candidate)."""
    from ..ops.geometry import backproject_depth, project_3d
    from ..ops.image import grid_sample_border
    from ..ops.ssim import ssim

    n, h, w = depths.shape
    dev = depths.device
    k = K_NORM.copy()
    k[0, :] *= w
    k[1, :] *= h
    inv_k = np.linalg.pinv(k)
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = baseline_sign * BASELINE

    def batch(m):
        return torch.from_numpy(m).to(dev)[None].expand(n, 4, 4)

    def image(x):
        return (x.to(torch.float32) / 255.0)[None].expand(n, h, w, 3)

    base, lookup = image(base_image), image(lookup_image)
    pts = backproject_depth(depths[..., None], batch(inv_k))
    pix = project_3d(pts, batch(k), batch(t), h, w)
    warped = grid_sample_border(lookup, pix)
    l1 = torch.abs(warped - base).mean(dim=-1)
    s = ssim(warped, base).mean(dim=-1)
    return 0.85 * s + 0.15 * l1


def fuse_depths(depths: np.ndarray, base_image: np.ndarray,
                lookup_image: np.ndarray, baseline_sign: int,
                device="cpu") -> np.ndarray:
    """Per pixel, the candidate depth of least reprojection loss
    (`precompute_depth_hints.py:243-249`), computed on `device`; (H, W)
    float32 on the host."""
    with torch.inference_mode():
        d = torch.from_numpy(np.ascontiguousarray(depths)).to(device)
        losses = fusion_losses(
            d, torch.from_numpy(np.ascontiguousarray(base_image)).to(device),
            torch.from_numpy(np.ascontiguousarray(lookup_image)).to(device),
            baseline_sign)
        best = torch.argmin(losses, dim=0)
        return torch.gather(d, 0, best[None])[0].cpu().numpy()


def main(argv=None) -> int:
    """Writes the hint files; returns how many it wrote."""
    from ..data.splits import readlines
    from ..utils import device as device_rule

    p = argparse.ArgumentParser(description="precompute_depth_hints")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--filenames", type=str, required=True)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--overwrite_saved_depths", action="store_true")
    p.add_argument("--num_workers", type=int, default=4,
                   help="threads over files: cv2's decode and the 12 SGBM "
                        "matchers release the GIL")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the fusion runs: cuda (raises without a "
                        "card) or cpu")
    args = p.parse_args(argv)

    device = device_rule.resolve_device(args.device)
    device_rule.pin_float32(device)
    cv2 = _cv2()
    cv2.setNumThreads(0)
    save_path = args.save_path or os.path.join(args.data_path, "depth_hints")
    files = readlines(args.filenames)
    print(f"Computing depth hints for {len(files)} files...")

    def process(line, matchers) -> int:
        folder, frame, side = line.split()
        frame = int(frame)
        side_folder = "image_02" if side == "l" else "image_03"
        other_folder = "image_03" if side == "l" else "image_02"
        out_dir = os.path.join(save_path, folder, side_folder)
        out_file = os.path.join(out_dir, f"{frame:010d}.npy")
        if os.path.exists(out_file) and not args.overwrite_saved_depths:
            return 0

        def load(img_folder):
            path = os.path.join(args.data_path, folder,
                                f"{img_folder}/data", f"{frame:010d}.jpg")
            if not os.path.exists(path):
                path = path[:-4] + ".png"
            img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            return cv2.resize(img, (args.width, args.height))

        base = load(side_folder)
        lookup = load(other_folder)
        depths = compute_depths(matchers, base, lookup, args.width,
                                reverse=(side == "r"))
        # side "l" -> -baseline, "r" -> +baseline
        # (`precompute_depth_hints.py:160-174`)
        best = fuse_depths(depths, base, lookup, -1 if side == "l" else 1,
                           device)
        os.makedirs(out_dir, exist_ok=True)
        np.save(out_file, best[None])
        return 1

    t0 = time.time()
    written = 0
    nw = max(1, args.num_workers)
    if nw == 1:
        matchers = generate_stereo_matchers()
        for i, line in enumerate(files):
            written += process(line, matchers)
            if i % 50 == 0 and i > 0:
                print(f"image {i}/{len(files)}  imgs/s: "
                      f"{i / (time.time() - t0):.2f}")
    else:
        # StereoSGBM objects are not thread-safe: one set per thread
        import threading
        from concurrent.futures import ThreadPoolExecutor
        tls = threading.local()

        def worker(line):
            if not hasattr(tls, "matchers"):
                tls.matchers = generate_stereo_matchers()
            return process(line, tls.matchers)

        with ThreadPoolExecutor(max_workers=nw) as pool:
            for i, n in enumerate(pool.map(worker, files)):
                written += n
                if i % 50 == 0 and i > 0:
                    print(f"image {i}/{len(files)}  imgs/s: "
                          f"{i / (time.time() - t0):.2f}")
    print("done.")
    return written


if __name__ == "__main__":
    main()
