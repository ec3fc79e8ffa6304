"""Synthetic KITTI-layout mount with exact geometry.

Counterpart of `wavelet_monodepth_tpu/data/synth.py`, with the same
scenes for the same seed: fronto-parallel textured rectangles at known
depths over a far background plane, as stereo pairs whose pixel
disparity is f * B / Z with B the true KITTI rig baseline (0.54 m),
while the loader and trainer assume the nominal 0.1 m, so the eval's x5.4
stereo scaling applies unchanged. Disparities are snapped to whole
full-res pixels and the GT depth is taken from the snapped disparity, so
GT and photometry agree to the pixel. The texture's low-frequency part
is upscaled with `ops/resize.resize_cubic` (OpenCV's INTER_CUBIC, within
1e-5), the JPEGs are written with PIL and the hints resized with
`data/kitti.resize_nearest`, so the port needs no cv2. `fabricate_nyu`
writes a synthetic NYU zip from the same renderer.

Writes the raw-KITTI directory scheme plus a split dir the CLIs resolve
via <data_path>/splits/<name> (data/splits.py):

  <root>/2011_09_26/2011_09_26_drive_%04d_sync/image_0{2,3}/data/*.jpg
  <root>/splits/eigen/{train,val,test}_files.txt
  <root>/splits/eigen/gt_depths.npz          (test-frame left-cam depth)

Usage:
  python -m wavelet_monodepth_tpu_torch.data.synth --root /tmp/kitti_synth \
      --n_train 480 --n_val 24 --n_test 32
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..ops.resize import resize_area_u8, resize_cubic
from .kitti import resize_nearest

FULL_W, FULL_H = 1242, 375
FOCAL = 0.58 * FULL_W          # K_NORM[0,0] * width
# TRUE rig baseline vs the 0.1 m NOMINAL the loader/trainer assume
# (`mono_dataset.py` stereo_T): 0.54 m reproduces KITTI's actual rig, so
# models trained on this mount predict depth/5.4 and the eval protocol's
# STEREO_SCALE_FACTOR=5.4 (`evaluate_depth.py:295`, eval/kitti_eval.py)
# recovers metric depth — the full published protocol applies unmodified.
BASELINE = 0.54
BG_DEPTH = 70.0                # < MAX_DEPTH=80 so eval masks keep it
DATE = "2011_09_26"
FRAMES_PER_DRIVE = 48


def _texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Base color + smooth low-frequency blobs + fine grain: enough
    high-frequency content for SGBM block matching, smooth enough that
    bilinear warps in the photometric loss behave."""
    base = rng.uniform(40, 215, size=3)
    low = resize_cubic(
        rng.uniform(-1, 1, (max(2, h // 24), max(2, w // 24), 3)), w, h)
    fine = rng.uniform(-1, 1, (h, w, 1))
    tex = base[None, None] + 38.0 * low + 18.0 * fine
    return np.clip(tex, 0, 255).astype(np.uint8)


def _snap_depth(z: float) -> tuple[float, int]:
    """Round the full-res disparity to an integer pixel and return the
    depth implied by that rounded disparity (plus the disparity)."""
    d = int(round(FOCAL * BASELINE / z))
    d = max(d, 1)
    return FOCAL * BASELINE / d, d


SKY = np.array([198.0, 204.0, 214.0])   # attenuation target color


def _attenuate(tex: np.ndarray, z: float, z_atten: float) -> np.ndarray:
    """Atmospheric attenuation: blend toward SKY with 1-exp(-z/L).

    This is the monocular depth cue of the fabricated world: random box
    layouts carry no appearance-to-depth relationship, so monocular
    depth on unseen scenes would be ambiguous however long a model
    trains. Fog gives depth a deterministic, local appearance; both
    stereo views of a surface get the same shading (same z), so stereo
    matching and the exact hints are untouched."""
    a = 1.0 - np.exp(-z / z_atten)
    return np.clip((1.0 - a) * tex.astype(np.float32)
                   + a * SKY[None, None], 0, 255).astype(np.uint8)


def render_scene(rng: np.random.RandomState, n_objects: int | None = None,
                 z_range: tuple[float, float] = (3.0, 40.0),
                 bg_depth: float = BG_DEPTH,
                 mono_cues: bool = True):
    """One scene -> (left u8, right u8 HxWx3, depth f32 HxW, depth_r).

    Painter's algorithm far->near; each object pasted at x in the left
    view and x - disp in the right view (KITTI: image_02 is the left
    color camera, so scene content sits at smaller x in image_03).
    ``depth``/``depth_r`` are the per-view TRUE depth maps (left and
    right camera respectively), each consistent with its own image.
    ``z_range``/``bg_depth`` bound the scene depths: the defaults mimic
    KITTI; small fast test mounts (e.g. 96x320 self-golden) should pass
    a NEARER range — at 1/4 eval resolution a 70 m background subtends
    <1.5 px of stereo disparity, below what photometric training can
    resolve there. ``mono_cues`` adds depth-correlated appearance
    (atmospheric attenuation + physical object sizes) so HELD-OUT
    monocular depth is learnable at all — see _attenuate."""
    if n_objects is None:
        n_objects = rng.randint(16, 28)
    z_atten = 0.75 * bg_depth

    bg_z, bg_d = _snap_depth(bg_depth)
    # background texture wider than the frame so the right view is the
    # same plane seen bg_d pixels to the left
    bg_tex = _texture(rng, FULL_H, FULL_W + bg_d)
    if mono_cues:
        bg_tex = _attenuate(bg_tex, bg_z, z_atten)
    left = bg_tex[:, bg_d:bg_d + FULL_W].copy()
    right = bg_tex[:, :FULL_W].copy()
    depth = np.full((FULL_H, FULL_W), bg_z, np.float32)
    depth_r = np.full((FULL_H, FULL_W), bg_z, np.float32)

    zs = np.sort(np.exp(rng.uniform(np.log(z_range[0]),
                                    np.log(z_range[1]),
                                    n_objects)))[::-1]
    for z in zs:
        z_eff, d = _snap_depth(float(z))
        if mono_cues:
            # fixed physical size range -> apparent size scales 1/z
            # (the classic size cue; clipped to keep paste bounds sane)
            w = int(np.clip(rng.uniform(0.7, 3.2) * FOCAL / z, 24, 640))
            h = int(np.clip(rng.uniform(0.5, 2.0) * FOCAL / z, 18, 300))
        else:
            w = rng.randint(60, 420)
            h = rng.randint(40, 260)
        x0 = rng.randint(-w // 3, FULL_W - 2 * w // 3)
        y0 = rng.randint(-h // 3, FULL_H - 2 * h // 3)
        tex = _texture(rng, h, w)
        if mono_cues:
            tex = _attenuate(tex, z_eff, z_atten)

        # left-view paste (clipped to frame)
        lx0, ly0 = max(x0, 0), max(y0, 0)
        lx1, ly1 = min(x0 + w, FULL_W), min(y0 + h, FULL_H)
        if lx1 > lx0 and ly1 > ly0:
            left[ly0:ly1, lx0:lx1] = tex[ly0 - y0:ly1 - y0,
                                         lx0 - x0:lx1 - x0]
            depth[ly0:ly1, lx0:lx1] = z_eff
        # right-view paste, shifted by the (integer) disparity
        rx = x0 - d
        rx0, rx1 = max(rx, 0), min(rx + w, FULL_W)
        if rx1 > rx0 and ly1 > ly0:
            right[ly0:ly1, rx0:rx1] = tex[ly0 - y0:ly1 - y0,
                                          rx0 - rx:rx1 - rx]
            depth_r[ly0:ly1, rx0:rx1] = z_eff
    return left, right, depth, depth_r


def fabricate(root: str, n_train: int = 480, n_val: int = 24,
              n_test: int = 32, split: str = "eigen", seed: int = 0,
              jpeg_quality: int = 95, progress: bool = True,
              write_hints: bool = False,
              hint_size: tuple[int, int] = (192, 640),
              z_range: tuple[float, float] = (3.0, 40.0),
              bg_depth: float = BG_DEPTH) -> dict:
    """Render and write the full mount; returns {'split_dir': ...}.

    write_hints=True also writes GEOMETRICALLY EXACT depth hints
    (depth_hints/<folder>/image_0{2,3}/<frame>.npy, [1,h,w] like
    tools/precompute_depth_hints.py) for train/val frames: the per-view
    true depth divided by 5.4 — i.e. expressed at the loader's nominal
    0.1 m baseline exactly as the SGBM precompute stores it (its
    disp->depth uses BASELINE=0.1). Lets tests exercise the hint-
    supervised production config without the multi-minute SGBM pass."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    split_dir = os.path.join(root, "splits", split)
    os.makedirs(split_dir, exist_ok=True)

    total = n_train + n_val + n_test
    lines: list[str] = []
    gt: list[np.ndarray] = []
    for i in range(total):
        drive = i // FRAMES_PER_DRIVE + 1
        frame = i % FRAMES_PER_DRIVE
        folder = f"{DATE}/{DATE}_drive_{drive:04d}_sync"
        l_img, r_img, depth, depth_r = render_scene(
            rng, z_range=z_range, bg_depth=bg_depth)
        for side, img in (("image_02", l_img), ("image_03", r_img)):
            d = os.path.join(root, folder, side, "data")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(img).save(os.path.join(d, f"{frame:010d}.jpg"),
                                      quality=jpeg_quality)
        if write_hints and i < n_train + n_val:
            hh, hw = hint_size
            for side, dmap in (("image_02", depth), ("image_03", depth_r)):
                d = os.path.join(root, "depth_hints", folder, side)
                os.makedirs(d, exist_ok=True)
                hint = resize_nearest(dmap / 5.4, hw, hh)
                np.save(os.path.join(d, f"{frame:010d}.npy"), hint[None])
        lines.append(f"{folder} {frame}")
        if i >= n_train + n_val:
            gt.append(depth)
        if progress and i and i % 100 == 0:
            print(f"rendered {i}/{total} scenes")

    def write(name, rows):
        with open(os.path.join(split_dir, name), "w") as f:
            f.write("\n".join(rows) + "\n")

    # train/val items exist for both sides (the loader's stereo frame is
    # the other camera); test is left-only to match the stored GT
    train = lines[:n_train]
    val = lines[n_train:n_train + n_val]
    test = lines[n_train + n_val:]
    write("train_files.txt",
          [f"{ln} {s}" for ln in train for s in ("l", "r")])
    write("val_files.txt", [f"{ln} {s}" for ln in val for s in ("l", "r")])
    write("test_files.txt", [f"{ln} l" for ln in test])
    # 1-D object array of 2-D float maps (np.array(gt, object) on the
    # all-same-shape synth maps would build a 3-D array of object
    # SCALARS, which real KITTI never produces and np.log rejects)
    gt_arr = np.empty(len(gt), object)
    for i, d in enumerate(gt):
        gt_arr[i] = d
    np.savez_compressed(
        os.path.join(split_dir, "gt_depths.npz"), data=gt_arr)
    return {"split_dir": split_dir, "n_items_train": 2 * n_train}


def fabricate_nyu(zip_path: str, n_train: int = 480, seed: int = 0,
                  depth_scale: float = 0.25) -> dict:
    """Synthetic nyu_data.zip (DenseDepth's train layout, `NYUv2/data.py:
    71-85`): data/nyu2_train.csv rows of (rgb png 640x480, depth png),
    the JAX package's `fabricate_nyu` without cv2. The RGB and depth come
    from the KITTI mount's renderer (left view and its true depth), the
    depths compressed by `depth_scale` into NYU's indoor range (0.75-17.5
    m by default; the train transform clamps them to 10 m: 8-bit png ->
    /255 -> x1000 -> clamp [10, 1000] cm, `data.py:107-140`). The view is
    resized with OpenCV's INTER_AREA (`ops/resize.resize_area_u8`, bit
    for bit), the depth with INTER_NEAREST (`data/kitti.resize_nearest`),
    and both are written as PNGs by PIL: other bytes than cv2's encoder,
    the same pixels."""
    import io
    import zipfile

    from PIL import Image

    def png(arr) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")
        return buf.getvalue()

    rng = np.random.RandomState(seed)
    rows = []
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for i in range(n_train):
            left, _, depth, _ = render_scene(rng)
            img = resize_area_u8(left, 640, 480)
            d = resize_nearest(depth * depth_scale, 640, 480)
            d8 = np.clip(d / 10.0 * 255.0, 1, 255).astype(np.uint8)
            zf.writestr(f"data/img_{i:05d}.png", png(img))
            zf.writestr(f"data/dep_{i:05d}.png", png(d8))
            rows.append(f"data/img_{i:05d}.png,data/dep_{i:05d}.png")
        zf.writestr("data/nyu2_train.csv", "\n".join(rows))
    return {"zip": zip_path, "n_train": n_train}


def main(argv=None):
    p = argparse.ArgumentParser(description="synthetic KITTI fabricator")
    p.add_argument("--root", required=True)
    p.add_argument("--n_train", type=int, default=480)
    p.add_argument("--n_val", type=int, default=24)
    p.add_argument("--n_test", type=int, default=32)
    p.add_argument("--split", default="eigen")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--write_hints", action="store_true",
                   help="also write exact depth hints (skips SGBM)")
    p.add_argument("--z_near", type=float, default=3.0)
    p.add_argument("--z_far", type=float, default=40.0)
    p.add_argument("--bg_depth", type=float, default=BG_DEPTH,
                   help="background plane depth, metres; at 640px a 70 m"
                        " background subtends ~3 px of stereo disparity"
                        " — prefer ~14 m for from-scratch photometric"
                        " training")
    args = p.parse_args(argv)
    out = fabricate(args.root, args.n_train, args.n_val, args.n_test,
                    args.split, args.seed, write_hints=args.write_hints,
                    z_range=(args.z_near, args.z_far),
                    bg_depth=args.bg_depth)
    print(f"wrote {out['n_items_train']} train items; "
          f"split dir {out['split_dir']}")


if __name__ == "__main__":
    main()
