"""Port parity, the KITTI eigen-split evaluation: metrics, the cv2-free
resizes, the scoring loop, predict_disps, velodyne GT, export_gt_depth,
the dataset's GT and layouts, the synthetic mount and
tools/evaluate_depth.main of wavelet_monodepth_tpu_torch against the JAX
package (and OpenCV, which the JAX package resizes with), at 64x96 on a
JAX-fabricated mount of 3 test frames.

Tolerances: metric functions 1e-12 (float64); resize_linear 1e-6
relative (it is bit for bit on float32), resize_cubic 1e-5 (float64);
scoring from the same disparities: rows 1e-5, ratios 1e-6; disparities
from crossed weights 1e-4 (encoder features differ by f32
reassociation, test_torch_port_models.py); op counts and densities
exactly; bf16 against JAX bf16 max 0.05 / mean 0.01 in the sigmoid
disparity (tests/test_bf16.py's bounds); end-to-end metric rows 1e-4; velodyne GT and export npz exactly;
synth GT and split files exactly, rendered uint8 images within 1 (the
cubic resize is within 1e-5 of OpenCV's, so a texture value can round
the other way), decoded JPEGs (PIL's encoder against OpenCV's) within 8
levels and 0.01 on average.
"""

import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wavelet_monodepth_tpu.data import kitti as jkitti
from wavelet_monodepth_tpu.data import kitti_utils as jku
from wavelet_monodepth_tpu.data import synth as jsynth
from wavelet_monodepth_tpu.eval import kitti_eval as jeval
from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.ops import metrics as jmetrics
from wavelet_monodepth_tpu.tools import evaluate_depth as jed
from wavelet_monodepth_tpu.tools import export_gt_depth as jexport
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.utils.config import parse_kitti_args as jparse
from wavelet_monodepth_tpu.utils.precision import cast_floats as jcast
from wavelet_monodepth_tpu.utils.precision import wrap_forward_bf16 as jwrap
from wavelet_monodepth_tpu_torch.data import kitti as tkitti
from wavelet_monodepth_tpu_torch.data import kitti_utils as tku
from wavelet_monodepth_tpu_torch.data import synth as tsynth
from wavelet_monodepth_tpu_torch.data.splits import readlines
from wavelet_monodepth_tpu_torch.eval import kitti_eval as teval
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.layers import init_params
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.ops import metrics as tmetrics
from wavelet_monodepth_tpu_torch.ops.resize import resize_cubic, \
    resize_linear
from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ted
from wavelet_monodepth_tpu_torch.tools import export_gt_depth as texport
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
H, W = 64, 96
N_TEST = 3
ARGS = ["--eval_stereo", "--use_wavelets", "--height", str(H), "--width",
        str(W)]


# --- fixtures ---------------------------------------------------------------

@pytest.fixture(scope="module")
def mount(tmp_path_factory):
    """A JAX-fabricated eigen mount: 1 train pair, 3 test frames."""
    root = str(tmp_path_factory.mktemp("synth") / "kitti")
    jsynth.fabricate(root, n_train=1, n_val=0, n_test=N_TEST,
                     progress=False)
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference folder of seeded port weights with non-trivial BN
    statistics, which both sides load."""
    folder = str(tmp_path_factory.mktemp("weights"))
    g = torch.Generator().manual_seed(11)
    enc = init_params(ResnetEncoder(18), g)
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), g)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(1 + 0.2 * torch.rand(c, generator=g))
    ti.save_reference_checkpoint(folder, enc, dec, H, W)
    return folder


def _jax_bf16_forward(folder):
    """JAX's bf16 eval forward (`tools/evaluate_depth.py:_load_forward`
    with --bfloat16) on the folder's weights as jax arrays. JAX's own
    function fails on a reference folder: its importer gives numpy
    arrays, cast to numpy bfloat16, with which the flax encoder returns
    float32 features that the bf16 decoder rejects (ROADMAP.md Queue 3)."""
    enc, dec = JEncoder(num_layers=18), JDecoder(num_ch_enc=j_num_ch_enc(18))
    ev = jti.import_resnet_encoder(
        jti.load_pth(os.path.join(folder, "encoder.pth")), 18)
    dv = jti.import_kitti_wavelet_decoder(
        jti.load_pth(os.path.join(folder, "depth.pth")))
    ev, dv = (jcast(jax.tree_util.tree_map(jnp.asarray, v), jnp.bfloat16)
              for v in (ev, dv))

    @jax.jit
    def forward(image):
        image = (image.astype(jnp.float32) / 255.0).astype(jnp.bfloat16)
        return dec.apply(dv, enc.apply(ev, image))
    return jwrap(lambda image, thresh: forward(image))


@pytest.fixture(scope="module")
def forwards(weights):
    """{name: (JAX forward, port forward)} in float32 and bf16, both from
    the reference folder (JAX through its own importer)."""
    topts = parse_kitti_args(ARGS + ["--device", "cpu"])
    out = {"f32": (jed._load_forward(jparse(ARGS), weights),
                   ted.load_forward(topts, "cpu", weights))}
    topts = parse_kitti_args(ARGS + ["--device", "cpu", "--bfloat16"])
    out["bf16"] = (_jax_bf16_forward(weights),
                   ted.load_forward(topts, "cpu", weights))
    with pytest.raises(TypeError, match="same dtypes"):
        jed._load_forward(jparse(ARGS + ["--bfloat16"]), weights)(
            jnp.zeros((1, H, W, 3), jnp.uint8), None)
    return out


@pytest.fixture(scope="module")
def images(mount):
    """The 3 test frames' uint8 eval feed, from the port's dataset (equal
    to JAX's)."""
    files = readlines(os.path.join(mount, "splits", "eigen",
                                   "test_files.txt"))
    tds = tkitti.KittiRawDataset(mount, files, H, W, [0], target_scales=[0],
                                 device_augment=True)
    jds = jkitti.KittiRawDataset(mount, files, H, W, [0], target_scales=[0],
                                 device_augment=True)
    key = ("color_u8", "0", 0)
    u8 = np.stack([tds[i][key] for i in range(len(tds))])
    np.testing.assert_array_equal(u8, np.stack([jds[i][key]
                                                for i in range(len(jds))]))
    assert u8.shape == (N_TEST, H, W, 3) and u8.dtype == np.uint8
    return u8


# --- metrics and resizes ----------------------------------------------------

def test_metrics_equal_jax():
    rng = np.random.RandomState(0)
    gt = rng.uniform(1, 80, 5000)
    pred = gt * rng.uniform(0.6, 1.6, 5000)
    for ours, ref in ((tmetrics.compute_errors_np(gt, pred),
                       jmetrics.compute_errors_np(gt, pred)),
                      (tmetrics.compute_errors_nyu_np(gt, pred),
                       jmetrics.compute_errors_nyu_np(gt, pred))):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    with jax.enable_x64(True):
        ref = jmetrics.compute_errors_jnp(jnp.asarray(gt), jnp.asarray(pred))
        ref_dtypes = [str(v.dtype) for v in ref]
        ref = [float(v) for v in ref]
    ours = tmetrics.compute_errors(torch.from_numpy(gt),
                                   torch.from_numpy(pred))
    # JAX's boolean means (a1-a3) are float32 even in float64 mode
    assert [str(v.dtype).split(".")[1] for v in ours] == ref_dtypes == [
        "float64"] * 4 + ["float32"] * 3
    np.testing.assert_allclose([float(v) for v in ours], ref, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("src,dst", [((192, 640), (375, 1242)),
                                     ((192, 640), (352, 1216)),
                                     ((37, 53), (101, 77)),
                                     ((64, 96), (13, 211))])
def test_resize_linear_equals_opencv(src, dst):
    rng = np.random.RandomState(src[0] + dst[1])
    for dtype in (np.float32, np.float64):
        a = (rng.rand(*src) * 0.3 + 0.01).astype(dtype)
        ref = cv2.resize(a, (dst[1], dst[0]))
        ours = resize_linear(a, dst[1], dst[0])
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        assert np.max(np.abs(ours - ref) / np.abs(ref)) <= 1e-6


@pytest.mark.parametrize("src,dst", [((15, 26), (375, 1242)),
                                     ((7, 13), (180, 320)),
                                     ((3, 2), (40, 30))])
def test_resize_cubic_equals_opencv(src, dst):
    a = np.random.RandomState(src[1]).uniform(-1, 1, src + (3,))
    ref = cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_CUBIC)
    ours = resize_cubic(a, dst[1], dst[0])
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


# --- scoring from the same disparities --------------------------------------

def _gt_maps(n, h, w, seed):
    """Sparse GT depth maps (70% empty), float32."""
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1, 90, (n, h, w)).astype(np.float32)
    gt[rng.rand(n, h, w) < 0.7] = 0
    return list(gt)


@pytest.mark.parametrize("stereo", [True, False])
@pytest.mark.parametrize("split", ["eigen", "eigen_benchmark"])
def test_scoring_equals_jax(stereo, split):
    rng = np.random.RandomState(4)
    pred = rng.uniform(0.01, 0.3, (3, 48, 160)).astype(np.float32)
    gt = _gt_maps(3, 120, 400, 5)
    for disps in (pred, teval.batch_post_process_disparity(
            pred, pred[:, :, ::-1] * 1.1)):
        ours = teval.evaluate_disps(disps, gt, eval_split=split,
                                    eval_stereo=stereo)
        ref = jeval.evaluate_disps(disps, gt, eval_split=split,
                                   eval_stereo=stereo)
        np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-6)
        assert len(ours[1]) == (0 if stereo else 3)
    np.testing.assert_array_equal(
        teval.batch_post_process_disparity(pred, pred[:, ::-1] + 0.1),
        jeval.batch_post_process_disparity(pred, pred[:, ::-1] + 0.1))
    np.testing.assert_array_equal(teval.eigen_crop_mask(gt[0]),
                                  jeval.eigen_crop_mask(gt[0]))
    assert teval.format_result_table(ours[0]) == \
        jeval.format_result_table(ours[0])
    with pytest.raises(ValueError, match="stereo"):
        teval.evaluate_disps(pred, gt)


# --- predict_disps on crossed weights ---------------------------------------

def _batches(u8, sizes):
    out, k = [], 0
    for s in sizes:
        out.append(u8[k:k + s])
        k += s
    return out


@pytest.mark.parametrize("case", ["dense_coeffs", "dense_pp", "sparse_pp"])
def test_predict_disps_equals_jax(forwards, images, case):
    """dense without post-process (one image per batch, coefficients
    collected), dense and sparse with it (the 3 images in one batch)."""
    jf, tf = forwards["f32"]
    kw = {"dense_coeffs": dict(collect_coeffs=True),
          "dense_pp": dict(post_process=True),
          "sparse_pp": dict(post_process=True, sparse_threshold=0.1)}[case]
    sizes = [1, 1, 1] if case == "dense_coeffs" else [3]
    ref, rinfo = jeval.predict_disps(jf, _batches(images, sizes), **kw)
    ours, info = teval.predict_disps(tf, _batches(images, sizes),
                                     device="cpu", **kw)
    assert ours.shape == ref.shape == (N_TEST, H, W)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert set(info) == set(rinfo)
    if case == "sparse_pp":
        assert info["total_ops_mean"] == rinfo["total_ops_mean"]
        assert info["density_mean"] == rinfo["density_mean"]
    if case == "dense_coeffs":
        assert sorted(info["coeffs"]) == sorted(rinfo["coeffs"]) == [
            0, 1, 2, 3]
        for s, v in rinfo["coeffs"].items():
            assert info["coeffs"][s].shape == v.shape == (
                N_TEST, 4, H >> (s + 1), W >> (s + 1))
            np.testing.assert_allclose(info["coeffs"][s], v, rtol=1e-5,
                                       atol=1e-4)


def test_predict_disps_feeds_and_batching(forwards, images):
    """uint8 == float feed; a batched sparse decode equals its images one
    by one, ops and densities included."""
    _, tf = forwards["f32"]
    u8, info = teval.predict_disps(tf, [images], device="cpu")
    f32, _ = teval.predict_disps(tf, [images.astype(np.float32) / 255.0],
                                 device="cpu")
    np.testing.assert_array_equal(u8, f32)
    kw = dict(device="cpu", sparse_threshold=0.1, post_process=True)
    batched, binfo = teval.predict_disps(tf, [images], **kw)
    single, sinfo = teval.predict_disps(tf, _batches(images, [1, 1, 1]), **kw)
    # the CPU's convs sum in a batch-dependent order: disparities 1e-4
    np.testing.assert_allclose(batched, single, rtol=0, atol=1e-4)
    assert binfo == sinfo


def test_bf16_predict_disps_near_jax_bf16(forwards, images):
    jf, tf = forwards["bf16"]
    ref, _ = jeval.predict_disps(jf, [images], post_process=True)
    ours, _ = teval.predict_disps(tf, [images], device="cpu",
                                  post_process=True)
    # the bounds hold the sigmoid disparity, in [0, 1]; predict_disps
    # gives it scaled to [1 / max_depth, 1 / min_depth] = [0.01, 10]
    gap = np.abs(ours - ref) / (1 / 0.1 - 1 / 100.0)
    assert gap.max() <= 0.05 and gap.mean() <= 0.01, (gap.max(), gap.mean())


# --- evaluate_depth.main end to end -----------------------------------------

@pytest.mark.parametrize("mode", [["--post_process"],
                                  ["--use_sparse", "--threshold", "0.1"]])
def test_evaluate_depth_main_equals_jax(mount, weights, mode, monkeypatch):
    argv = ["--data_path", mount, "--batch_size", "3"] + ARGS + mode
    monkeypatch.setenv("WMD_TORCH_MODEL_PATH", weights)
    ref = jed.main(argv)
    monkeypatch.delenv("WMD_TORCH_MODEL_PATH")
    ours = ted.main(argv + ["--device", "cpu", "--torch_model_path", weights])
    assert list(ours["metrics"]) == list(ref["metrics"])
    np.testing.assert_allclose(list(ours["metrics"].values()),
                               list(ref["metrics"].values()), rtol=0,
                               atol=1e-4)
    assert len(ours["ratios"]) == len(ref["ratios"]) == 0
    assert ours["density_mean"] == ref["density_mean"]
    assert ours["total_ops_mean"] == ref["total_ops_mean"]


def test_evaluate_depth_main_baseline_equals_jax(mount, tmp_path,
                                                 monkeypatch):
    """The baseline DepthDecoder (no --use_wavelets) from a reference
    folder, dense with post-processing: the row equals JAX's."""
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
        DepthDecoder
    folder = str(tmp_path / "baseline")
    g = torch.Generator().manual_seed(12)
    enc = init_params(ResnetEncoder(18), g)
    ti.save_reference_checkpoint(folder, enc,
                                 init_params(DepthDecoder(enc.num_ch_enc), g),
                                 H, W)
    argv = ["--data_path", mount, "--batch_size", "3", "--eval_stereo",
            "--height", str(H), "--width", str(W), "--post_process"]
    monkeypatch.setenv("WMD_TORCH_MODEL_PATH", folder)
    ref = jed.main(argv)
    monkeypatch.delenv("WMD_TORCH_MODEL_PATH")
    ours = ted.main(argv + ["--device", "cpu", "--torch_model_path", folder])
    assert list(ours["metrics"]) == list(ref["metrics"])
    np.testing.assert_allclose(list(ours["metrics"].values()),
                               list(ref["metrics"].values()), rtol=0,
                               atol=1e-4)


def test_evaluate_depth_main_flags(mount, weights, tmp_path, monkeypatch):
    """--save_pred_disps into --load_weights_folder (with coefficients),
    --ext_disp_to_eval rescoring them to the same row, --no_eval,
    the benchmark PNGs, the mono/stereo check, --native_decode's own
    error where the native library cannot be built, and the default
    device, which needs a card."""
    folder = str(tmp_path / "ckpt")
    shutil.copytree(weights, folder)
    base = ["--data_path", mount, "--device", "cpu"] + ARGS
    first = ted.main(base + ["--load_weights_folder", folder,
                             "--save_pred_disps"])
    disps = np.load(os.path.join(folder, "disps_eigen_split.npy"))
    assert disps.shape == (N_TEST, H, W)
    for s in range(4):
        c = np.load(os.path.join(folder,
                                 f"disps_coeffs_s{s}_eigen_split.npy"))
        assert c.shape == (N_TEST, 4, H >> (s + 1), W >> (s + 1))
    again = ted.main(base + ["--ext_disp_to_eval",
                             os.path.join(folder, "disps_eigen_split.npy")])
    assert again["metrics"] == first["metrics"]
    assert ted.main(base + ["--load_weights_folder", folder,
                            "--no_eval"]) is None

    # the online benchmark's PNGs, as JAX writes them with OpenCV
    split = os.path.join(mount, "splits", "benchmark")
    os.makedirs(split, exist_ok=True)
    shutil.copy(os.path.join(mount, "splits", "eigen", "test_files.txt"),
                split)
    assert ted.main(base + ["--eval_split", "benchmark",
                            "--load_weights_folder", folder,
                            "--ext_disp_to_eval", os.path.join(
                                folder, "disps_eigen_split.npy")]) is None
    for i in range(N_TEST):
        png = np.asarray(Image.open(os.path.join(
            folder, "benchmark_predictions", f"{i:010d}.png")))
        assert png.shape == (352, 1216) and png.dtype == np.uint16
        ref = np.clip(teval.STEREO_SCALE_FACTOR
                      / cv2.resize(disps[i], (1216, 352)), 0, 80)
        np.testing.assert_array_equal(png, np.uint16(ref * 256))

    with pytest.raises(ValueError, match="eval_mono"):
        ted.main(["--data_path", mount, "--device", "cpu"])
    # no fallback to the PIL feed: a host without g++ gets the port's error
    from wavelet_monodepth_tpu_torch.data import native_loader
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "missing_requirements",
                        lambda: ["g++"])
    with pytest.raises(native_loader.NativeUnavailable, match=r"g\+\+"):
        ted.main(base + ["--load_weights_folder", folder, "--native_decode"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            ted.main(["--data_path", mount, "--torch_model_path", weights]
                     + ARGS)


# --- velodyne GT, export_gt_depth, the dataset's GT and layouts -------------

FOLDER = "2011_09_26/2011_09_26_drive_0002_sync"


def _write_raw_gt(root, frames=(0, 1), size=(200, 60)):
    """calib files, velodyne .bin files (with points that land on one
    pixel at several depths) and improved-GT 16-bit PNGs."""
    calib = os.path.join(root, FOLDER.split("/")[0])
    os.makedirs(calib, exist_ok=True)
    w, h = size
    with open(os.path.join(calib, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {w} {h}\n"
                "R_rect_00: 1 0 0.01 0 1 0 -0.01 0 1\n"
                f"P_rect_02: 80 0 {w / 2} 4.5 0 80 {h / 2} 0 0 0 1 0.003\n"
                f"P_rect_03: 80 0 {w / 2} -38.1 0 80 {h / 2} 0 0 0 1 0\n"
                "calib_time: 09-Jan-2012 13:57:47\n")
    with open(os.path.join(calib, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: -0.004 -0.07 -0.27\n")
    rng = np.random.RandomState(7)
    for fr in frames:
        pts = np.stack([rng.uniform(-5, 60, 4000), rng.uniform(-20, 20, 4000),
                        rng.uniform(-3, 2, 4000), rng.rand(4000)], 1)
        dup = pts[:300].copy()
        dup[:, :3] *= rng.uniform(1.2, 2.0, (300, 1))   # same ray, farther
        pts = np.concatenate([dup, pts, pts[:50]]).astype(np.float32)
        d = os.path.join(root, FOLDER, "velodyne_points", "data")
        os.makedirs(d, exist_ok=True)
        pts.tofile(os.path.join(d, f"{fr:010d}.bin"))
        for cam in ("02", "03"):
            d = os.path.join(root, FOLDER, "proj_depth", "groundtruth",
                             f"image_{cam}")
            os.makedirs(d, exist_ok=True)
            g = (rng.rand(h + 3, w + 5) * 60 * 256).astype(np.uint16)
            g[rng.rand(h + 3, w + 5) < 0.8] = 0
            Image.fromarray(g).save(os.path.join(d, f"{fr:010d}.png"))
    return calib


def test_generate_depth_map_equals_jax(tmp_path):
    calib = _write_raw_gt(str(tmp_path))
    velo = os.path.join(tmp_path, FOLDER, "velodyne_points", "data",
                        f"{0:010d}.bin")
    for cam, vel_depth in ((2, False), (2, True), (3, False)):
        ours = tku.generate_depth_map(calib, velo, cam, vel_depth)
        ref = jku.generate_depth_map(calib, velo, cam, vel_depth)
        assert ours.dtype == ref.dtype and (ours > 0).sum() > 100
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tku.load_velodyne_points(velo),
                                  jku.load_velodyne_points(velo))
    ref = jku.read_calib_file(os.path.join(calib, "calib_cam_to_cam.txt"))
    ours = tku.read_calib_file(os.path.join(calib, "calib_cam_to_cam.txt"))
    assert ours.keys() == ref.keys() and ours["calib_time"] == \
        ref["calib_time"]


@pytest.mark.parametrize("split", ["eigen", "eigen_benchmark"])
def test_export_gt_depth_equals_jax(tmp_path, split):
    root = str(tmp_path / "data")
    _write_raw_gt(root)
    outs = []
    for side, main in (("jax", jexport.main), ("port", texport.main)):
        sdir = tmp_path / side / split
        os.makedirs(sdir)
        (sdir / "test_files.txt").write_text(
            f"{FOLDER} 0 l\n{FOLDER} 1 l\n")
        main(["--data_path", root, "--split", split, "--splits_dir",
              str(tmp_path / side)])
        outs.append(np.load(sdir / "gt_depths.npz", allow_pickle=True)["data"])
    ref, ours = outs
    assert ours.dtype == ref.dtype == object and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.astype(np.float32),
                                  ref.astype(np.float32))


def test_dataset_gt_and_layouts_equal_jax(tmp_path):
    root = str(tmp_path)
    _write_raw_gt(root)
    lines = [f"{FOLDER} 0 l", f"{FOLDER} 1 r"]
    for layout in ("kitti", "kitti_depth", "kitti_odom"):
        tds = tkitti.KittiRawDataset(root, lines, H, W, [0],
                                     dataset=layout)
        jds = jkitti.KittiRawDataset(root, lines, H, W, [0], dataset=layout)
        folder = "4" if layout == "kitti_odom" else FOLDER
        for side in ("l", "r"):
            assert tds.get_image_path(folder, 7, side) == \
                jds.get_image_path(folder, 7, side)
            if layout == "kitti_odom":
                continue
            for frame, flip in ((0, False), (1, True)):
                ours = tds.get_depth(FOLDER, frame, side, flip)
                ref = jds.get_depth(FOLDER, frame, side, flip)
                assert ours.shape == (375, 1242)
                np.testing.assert_array_equal(ours, ref)


# --- the synthetic mount -----------------------------------------------------

def test_render_scene_equals_jax():
    ours = tsynth.render_scene(np.random.RandomState(3))
    ref = jsynth.render_scene(np.random.RandomState(3))
    for o, r in zip(ours[:2], ref[:2]):
        assert o.dtype == r.dtype == np.uint8
        assert np.abs(o.astype(int) - r).max() <= 1
    for o, r in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(o, r)


def test_fabricate_equals_jax(tmp_path):
    jr, tr = str(tmp_path / "jax"), str(tmp_path / "port")
    jsynth.fabricate(jr, n_train=1, n_val=1, n_test=1, progress=False,
                     write_hints=True)
    tsynth.main(["--root", tr, "--n_train", "1", "--n_val", "1",
                 "--n_test", "1", "--write_hints"])
    split = os.path.join("splits", "eigen")
    for name in ("train_files.txt", "val_files.txt", "test_files.txt"):
        assert open(os.path.join(tr, split, name)).read() == \
            open(os.path.join(jr, split, name)).read()
    ours = np.load(os.path.join(tr, split, "gt_depths.npz"),
                   allow_pickle=True)["data"]
    ref = np.load(os.path.join(jr, split, "gt_depths.npz"),
                  allow_pickle=True)["data"]
    assert ours.shape == ref.shape == (1,)
    np.testing.assert_array_equal(ours[0], ref[0])
    n = 0
    for dirpath, _, names in os.walk(jr):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), jr)
            if name.endswith(".npy"):
                np.testing.assert_array_equal(
                    np.load(os.path.join(tr, rel)),
                    np.load(os.path.join(jr, rel)))
            elif name.endswith(".jpg"):
                a = np.asarray(Image.open(os.path.join(tr, rel)), float)
                b = np.asarray(Image.open(os.path.join(jr, rel)), float)
                gap = np.abs(a - b)
                assert gap.max() <= 8 and gap.mean() <= 0.01, rel
                n += 1
    assert n == 6
