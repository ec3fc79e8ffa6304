"""Port parity, the KITTI input pipeline and the training CLI: the port's
KittiRawDataset, nearest resize, loader and split resolution against the
JAX package's on a tiny PIL-written KITTI mount, and
tools/train_kitti.main end to end on the CPU.

Items and batches must be equal exactly (the same PIL operations on the
same files with the same per-item RNG keys); the hint resize must equal
OpenCV's INTER_NEAREST exactly.
"""

import os
import random

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from wavelet_monodepth_tpu.data import kitti as jkitti
from wavelet_monodepth_tpu.data import loader as jloader
from wavelet_monodepth_tpu.data import splits as jsplits
from wavelet_monodepth_tpu_torch.data import kitti as tkitti
from wavelet_monodepth_tpu_torch.data import loader as tloader
from wavelet_monodepth_tpu_torch.data import splits as tsplits
from wavelet_monodepth_tpu_torch.utils import maskgen
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
H, W = 64, 96
FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


def write_mount(root, n, h, w, seed=0):
    """n stereo pairs (h, w) JPEG from maskgen scenes, the right view
    shifted by the scene's disparity; depth hints for all but the last
    frame (the loader's zero-mask fallback); a split "tiny"."""
    disp = maskgen.synthetic_depth_scene(n, h, w, seed=seed)[..., 0]
    left = (maskgen.scene_image(disp[..., None], seed=seed) * 255).astype(
        np.uint8)
    d_px = 1.0 + disp * 0.03 * w
    for side in ("02", "03"):
        os.makedirs(os.path.join(root, FOLDER, f"image_{side}", "data"))
        os.makedirs(os.path.join(root, "depth_hints", FOLDER,
                                 f"image_{side}"))
    lines = []
    for k in range(n):
        src_x = np.clip(np.round(np.arange(w)[None] + d_px[k]).astype(int),
                        0, w - 1)
        right = np.take_along_axis(left[k], src_x[..., None].repeat(3, -1),
                                   axis=1)
        for side, img in (("02", left[k]), ("03", right)):
            Image.fromarray(img).save(os.path.join(
                root, FOLDER, f"image_{side}", "data", f"{k:010d}.jpg"))
            if k < n - 1:
                depth = (0.58 * w * 0.1 / d_px[k]).astype(np.float32)
                depth[: h // 8] = 0.0
                np.save(os.path.join(root, "depth_hints", FOLDER,
                                     f"image_{side}", f"{k:010d}.npy"),
                        depth[None])
        lines.append(f"{FOLDER} {k} {'l' if k % 2 == 0 else 'r'}")
    split = os.path.join(root, "splits", "tiny")
    os.makedirs(split)
    for name in ("train_files.txt", "val_files.txt"):
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return lines


@pytest.fixture(scope="module")
def mount(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    return root, write_mount(root, 5, 75, 124)


def _datasets(mount, **kw):
    root, lines = mount
    args = (root, lines, H, W, [0, "s"], [0, 1, 2, 3])
    kw = dict(dict(is_train=True, use_depth_hints=True), **kw)
    return jkitti.KittiRawDataset(*args, **kw), \
        tkitti.KittiRawDataset(*args, **kw)


@pytest.mark.parametrize("feed", [
    dict(device_augment=True, aug_scales=(0,), other_frame_scales=(0,)),
    dict(device_augment=False),
    dict(device_augment=False, is_train=False)])
def test_items_equal_jax(mount, feed):
    jds, tds = _datasets(mount, **feed)
    for i in range(len(jds)):
        ref = jds.item(i, random.Random(f"0/0/{i}"))
        ours = tds.item(i, random.Random(f"0/0/{i}"))
        assert set(ours) == set(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=str(k))


@pytest.mark.parametrize("src,dst", [((375, 1242), (192, 640)),
                                     ((75, 124), (64, 96)),
                                     ((20, 30), (64, 96)),
                                     ((31, 47), (13, 17))])
def test_resize_nearest_equals_opencv(src, dst):
    a = np.random.RandomState(0).rand(*src).astype(np.float32)
    np.testing.assert_array_equal(
        tkitti.resize_nearest(a, dst[1], dst[0]),
        cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST))


def test_loader_stream_equals_jax_for_any_worker_count(mount):
    jds, tds = _datasets(mount, device_augment=True, aug_scales=(0,),
                         other_frame_scales=(0,))
    ref = list(jloader.parallel_batches(jds, 2, num_workers=0, epochs=2))
    for workers in (0, 3):
        ours = list(tloader.parallel_batches(tds, 2, num_workers=workers,
                                             epochs=2))
        assert len(ours) == len(ref) == 4
        for a, b in zip(ours, ref):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    tensors = next(tloader.to_device(iter(ref[:1]), "cpu"))
    for k, v in ref[0].items():
        assert torch.is_tensor(tensors[k])
        np.testing.assert_array_equal(tensors[k].numpy(), v)


def test_loader_stops_its_threads_when_closed(mount):
    import threading
    _, tds = _datasets(mount)
    n_threads = threading.active_count()
    stream = tloader.parallel_batches(tds, 2, num_workers=2)
    next(stream)
    assert threading.active_count() > n_threads
    stream.close()
    assert threading.active_count() == n_threads


def test_splits_resolve_like_jax(mount):
    root, _ = mount
    for split in ("eigen_zhou", "eigen"):
        assert tsplits.resolve_split_dir(split) == \
            jsplits.resolve_split_dir(split)
    assert tsplits.resolve_split_dir("tiny", root) == os.path.join(
        root, "splits", "tiny")
    assert len(tsplits.read_split("eigen")) == 697
    with pytest.raises(FileNotFoundError):
        tsplits.resolve_split_dir("no_such_split")


def test_other_layouts_raise(mount):
    """An unknown layout raises; the odometry and improved-depth layouts
    (ported with the eval) build, and ds[i] refuses a training dataset."""
    root, lines = mount
    with pytest.raises(ValueError, match="dataset"):
        tkitti.KittiRawDataset(root, lines, H, W, [0], dataset="kitti_nope")
    for layout in ("kitti_odom", "kitti_depth"):
        tkitti.KittiRawDataset(root, lines, H, W, [0], dataset=layout)
    with pytest.raises(ValueError, match="rng"):
        tkitti.KittiRawDataset(root, lines, H, W, [0], is_train=True)[0]


# --- the training CLI --------------------------------------------------------

def _argv(root, log, *extra):
    return ["--data_path", root, "--split", "tiny", "--log_dir", log,
            "--batch_size", "2", "--height", str(H), "--width", str(W),
            "--use_stereo", "--frame_ids", "0", "--use_depth_hints",
            "--use_wavelets", "--weights_init", "scratch",
            "--num_epochs", "1", "--num_workers", "2", *extra]


def test_train_main_on_cpu_writes_a_servable_checkpoint(mount, tmp_path):
    """Two steps with the banded warp "on" (its plain version on the CPU),
    one validation batch, the epoch's checkpoint; --auto_resume then finds
    it and skips the finished epoch; tools/infer serves it."""
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.tools import infer, train_kitti
    root, _ = mount
    log = str(tmp_path / "log")
    before = dict(warp.launches)
    summary = train_kitti.main(_argv(root, log, "--stereo_warp_kernel", "on",
                                     "--device", "cpu"))
    assert warp.launches == before              # CPU: the plain version
    assert summary["steps"] == 2 and summary["val_batches"] == 1
    assert all(np.isfinite(v) for v in summary["losses"][0].values())
    folder = os.path.join(log, "mdp", "models", "weights_0")
    assert summary["checkpoints"] == [folder]
    assert sorted(os.listdir(folder)) == ["adam.pth", "depth.pth",
                                          "encoder.pth"]
    again = train_kitti.main(_argv(root, log, "--auto_resume",
                                   "--device", "cpu"))
    assert again["steps"] == 0
    img = str(tmp_path / "x.png")
    Image.fromarray(np.zeros((40, 60, 3), np.uint8)).save(img)
    infer.main(["--image_path", img, "--torch_model_path", folder,
                "--device", "cpu"])
    assert np.load(str(tmp_path / "x_disp.npy")).shape == (1, 1, H, W)


def test_entry_points_raise_without_a_card(mount, tmp_path):
    """Without --device cpu the CLIs run on the card, and raise when none
    is visible (no quiet CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from wavelet_monodepth_tpu_torch.tools import infer, train_kitti
    root, _ = mount
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_kitti.main(_argv(root, str(tmp_path / "log")))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        infer.main(["--image_path", str(tmp_path), "--torch_model_path",
                    str(tmp_path)])
