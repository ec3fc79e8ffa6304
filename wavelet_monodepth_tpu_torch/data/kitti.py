"""KITTI input pipeline on the host: NHWC numpy items.

Counterpart of `wavelet_monodepth_tpu/data/kitti.py` (`KITTI/datasets/
mono_dataset.py:44-350`, `kitti_dataset.py:18-118`) for the raw-KITTI
layout (`dataset="kitti"`), the odometry layout (`"kitti_odom"`) and the
improved-depth layout (`"kitti_depth"`): split lines "folder frame side",
GT depth (`get_depth`), the Lanczos resize pyramid, colour jitter shared
by an item's frames, 50% horizontal flip, per-scale intrinsics, the
stereo extrinsics with the +-0.1 baseline, and per-frame depth hints with
a zero-mask fallback when the .npy is missing. Items use the same tuple keys and values as the JAX package's.

The depth hints and the velodyne GT are resized with `resize_nearest`,
which equals OpenCV's INTER_NEAREST, so the port does not need cv2.
`ds[i]` is the evaluation's item: it draws nothing, so it refuses a
training dataset, whose items take their draws from `item(i, rng)`.
"""

from __future__ import annotations

import os
import random
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageEnhance

from .kitti_utils import generate_depth_map

MIN_DEPTH = 0.1
MAX_DEPTH = 100.0

# normalised intrinsics (`kitti_dataset.py:24-28`)
K_NORM = np.array([[0.58, 0, 0.5, 0],
                   [0, 1.92, 0.5, 0],
                   [0, 0, 1, 0],
                   [0, 0, 0, 1]], dtype=np.float32)

SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}
FULL_RES_SHAPE = (1242, 375)


def depth_to_disp_np(depth: np.ndarray, min_depth=MIN_DEPTH,
                     max_depth=MAX_DEPTH) -> np.ndarray:
    min_disp, max_disp = 1.0 / max_depth, 1.0 / min_depth
    disp = 1.0 / (depth + 1e-5)
    disp = (disp - min_disp) / (max_disp - min_disp)
    disp[depth <= 0] = 0
    disp[disp <= 0] = 0
    return disp


def resize_nearest(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest-neighbour resize of a 2-D array, OpenCV's INTER_NEAREST:
    source index floor(dst * (1 / (dst_size / src_size))), in double,
    clamped to the last source index."""
    h, w = a.shape[:2]

    def index(dst: int, src: int) -> np.ndarray:
        inv = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                          src - 1)
    return a[index(height, h)[:, None], index(width, w)[None, :]]


def _jitter_params(rng: random.Random):
    """Brightness/contrast/saturation in (0.8, 1.2), hue in (-0.1, 0.1),
    the same for all frames of one item."""
    return dict(brightness=rng.uniform(0.8, 1.2),
                contrast=rng.uniform(0.8, 1.2),
                saturation=rng.uniform(0.8, 1.2),
                hue=rng.uniform(-0.1, 0.1))


def _apply_jitter(img: Image.Image, p: dict) -> Image.Image:
    img = ImageEnhance.Brightness(img).enhance(p["brightness"])
    img = ImageEnhance.Contrast(img).enhance(p["contrast"])
    img = ImageEnhance.Color(img).enhance(p["saturation"])
    if abs(p["hue"]) > 1e-6:
        hsv = np.array(img.convert("HSV"), dtype=np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(p["hue"] * 255)) % 256
        img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return img


class KittiRawDataset:
    """`KITTIRAWDataset`. `aug_scales` / `other_frame_scales` trim the item
    to what the step reads (the CLI passes (0,) for both); None keeps the
    reference-shaped item. `device_augment=True` emits uint8
    ("color_u8", fid, s) frames and a ("jitter",) factor vector instead of
    float colours and host-jittered color_aug (`ops/augment.expand_batch`
    finishes them on the card)."""

    def __init__(self, data_path: str, filenames: Sequence[str],
                 height: int, width: int, frame_idxs: Sequence,
                 target_scales: Sequence[int] = (0, 1, 2, 3),
                 is_train: bool = False, img_ext: str = ".jpg",
                 use_depth_hints: bool = False,
                 depth_hint_path: Optional[str] = None,
                 dataset: str = "kitti",
                 aug_scales: Optional[Sequence[int]] = None,
                 other_frame_scales: Optional[Sequence[int]] = None,
                 device_augment: bool = False):
        if dataset not in ("kitti", "kitti_odom", "kitti_depth"):
            raise ValueError(f"unknown dataset={dataset!r}: kitti, "
                             "kitti_odom or kitti_depth")
        self.dataset = dataset
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_idxs = list(frame_idxs)
        self.target_scales = list(target_scales)
        self.is_train = is_train
        self.img_ext = img_ext
        self.use_depth_hints = use_depth_hints
        self.depth_hint_path = (depth_hint_path or
                                os.path.join(data_path, "depth_hints"))
        self.aug_scales = (list(target_scales) if aug_scales is None
                           else list(aug_scales))
        self.other_frame_scales = (
            list(target_scales) if other_frame_scales is None
            else list(other_frame_scales))
        self.device_augment = device_augment

    def __len__(self):
        return len(self.filenames)

    def get_image_path(self, folder: str, frame_index: int,
                       side: str) -> str:
        if self.dataset == "kitti_odom":
            return os.path.join(
                self.data_path, f"sequences/{int(folder):02d}",
                f"image_{SIDE_MAP[side]}",
                f"{frame_index:06d}{self.img_ext}")
        return os.path.join(self.data_path, folder,
                            f"image_0{SIDE_MAP[side]}/data",
                            f"{frame_index:010d}{self.img_ext}")

    def get_color(self, folder, frame_index, side, do_flip) -> Image.Image:
        with open(self.get_image_path(folder, frame_index, side),
                  "rb") as f:
            img = Image.open(f).convert("RGB")
        if do_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    def get_depth(self, folder, frame_index, side, do_flip) -> np.ndarray:
        """GT depth at the full-res shape: the velodyne projection for the
        raw layout (`kitti_dataset.py:54-69`), the improved GT's 16-bit
        PNG / 256 for "kitti_depth" (`kitti_dataset.py:103-118`)."""
        if self.dataset == "kitti_depth":
            depth_path = os.path.join(
                self.data_path, folder,
                f"proj_depth/groundtruth/image_0{SIDE_MAP[side]}",
                f"{int(frame_index):010d}.png")
            depth = np.asarray(Image.open(depth_path).resize(
                FULL_RES_SHAPE, Image.NEAREST), np.float32) / 256.0
        else:
            calib_path = os.path.join(self.data_path, folder.split("/")[0])
            velo = os.path.join(
                self.data_path, folder,
                f"velodyne_points/data/{int(frame_index):010d}.bin")
            depth = generate_depth_map(calib_path, velo, SIDE_MAP[side])
            depth = resize_nearest(depth, *FULL_RES_SHAPE)
        if do_flip:
            depth = np.fliplr(depth)
        return depth

    def __getitem__(self, index: int) -> dict:
        """The evaluation's item (no augmentation, nothing drawn)."""
        if self.is_train:
            raise ValueError("a training item draws its augmentation: call "
                             "item(index, rng)")
        return self.item(index, None)

    def item(self, index: int, rng: Optional[random.Random]) -> dict:
        """One item; `rng` keys its augmentation draws (the loader passes
        one per (seed, epoch, index)); None only when not training."""
        inputs: dict = {}
        do_aug = self.is_train and rng.random() > 0.5
        do_flip = self.is_train and rng.random() > 0.5

        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1]) if len(line) == 3 else 0
        side = line[2] if len(line) == 3 else None

        raw: dict = {}
        for i in self.frame_idxs:
            if i == "s":
                other = {"r": "l", "l": "r"}[side]
                raw[i] = self.get_color(folder, frame_index, other, do_flip)
            else:
                raw[i] = self.get_color(folder, frame_index + i, side,
                                        do_flip)

        jit = _jitter_params(rng) if do_aug else None
        for i, img in raw.items():
            frame_scales = (self.target_scales if str(i) == "0"
                            else self.other_frame_scales)
            prev = img
            for s in self.target_scales:
                if s > max(frame_scales):
                    break
                w, h = self.width // 2 ** s, self.height // 2 ** s
                prev = prev.resize((w, h), Image.LANCZOS)
                if s not in frame_scales:
                    continue
                if self.device_augment:
                    inputs[("color_u8", str(i), s)] = np.asarray(
                        prev, np.uint8)
                    continue
                inputs[("color", str(i), s)] = (np.asarray(prev, np.float32)
                                                / 255.0)
                if s in self.aug_scales:
                    aug = _apply_jitter(prev, jit) if jit else prev
                    inputs[("color_aug", str(i), s)] = (
                        np.asarray(aug, np.float32) / 255.0)
        if self.device_augment:
            inputs[("jitter",)] = np.asarray(
                [jit["brightness"], jit["contrast"], jit["saturation"],
                 jit["hue"]] if jit else [1.0, 1.0, 1.0, 0.0], np.float32)

        for s in self.target_scales:
            k = K_NORM.copy()
            k[0, :] *= self.width // 2 ** s
            k[1, :] *= self.height // 2 ** s
            inputs[("K", s)] = k
            inputs[("inv_K", s)] = np.linalg.pinv(k).astype(np.float32)

        if "s" in self.frame_idxs:
            stereo_t = np.eye(4, dtype=np.float32)
            baseline_sign = -1 if do_flip else 1
            side_sign = -1 if side == "l" else 1
            stereo_t[0, 3] = side_sign * baseline_sign * 0.1
            inputs[("stereo_T",)] = stereo_t
            if self.use_depth_hints:
                inputs.update(self._hints(folder, frame_index, side,
                                          do_flip))
        return inputs

    def _hints(self, folder, frame_index, side, do_flip) -> dict:
        side_folder = "image_02" if side == "l" else "image_03"
        hint_file = os.path.join(self.depth_hint_path, folder, side_folder,
                                 str(frame_index).zfill(10) + ".npy")
        try:
            depth = np.load(hint_file)[0]
        except FileNotFoundError:
            # zero-mask fallback with the found branch's key set, so the
            # batch collates whatever the hints on disk
            z = np.zeros((self.height, self.width, 1), np.float32)
            return {("depth_hint",): z, ("depth_hint_mask",): z,
                    ("disp_hint",): z}
        if do_flip:
            depth = np.fliplr(depth)
        depth = resize_nearest(depth, self.width, self.height)
        depth = depth.astype(np.float32)
        return {("depth_hint",): depth[..., None],
                ("depth_hint_mask",): (depth > 0).astype(np.float32)[..., None],
                ("disp_hint",): depth_to_disp_np(depth)[..., None]}
