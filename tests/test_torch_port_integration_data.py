"""The port's release gates: the twin of tests/test_integration_data.py,
run through wavelet_monodepth_tpu_torch's evaluators
(tools/evaluate_depth.py, evaluate_nyu.py, evaluate_pose.py). Same
environment variables, published targets and tolerances (GOLDEN_GATES.md);
each gate runs only when its data is mounted and skips otherwise. Vet the
mounts first with `python -m wavelet_monodepth_tpu_torch.tools.
golden_check`.

Each gate runs on the card when one is visible and on the CPU otherwise,
and prints which: the scores must not depend on it (the card's float32
runs with TF32 off, `utils/device.pin_float32`).

  WMD_KITTI_DATA            KITTI raw root (with splits/ + gt_depths.npz)
  WMD_KITTI_WEIGHTS         R18 640x192 reference weights folder
                            (encoder.pth/depth.pth)
  WMD_KITTI_WEIGHTS_R50     R50 640x192 weights folder
  WMD_KITTI_WEIGHTS_R18_1024 / WMD_KITTI_WEIGHTS_R50_1024
                            1024x320 weights folders
  WMD_KITTI_ODOM_DATA       KITTI odometry root (sequences/ + poses/)
  WMD_KITTI_POSE_WEIGHTS    pose weights folder (pose_encoder.pth/pose.pth)
  WMD_NYU_MAT               nyu_depth_v2_labeled.mat
  WMD_NYU_SPLITS            splits.mat
  WMD_NYU_WEIGHTS           reference DenseNet161 DecoderWave model.pth
  WMD_NYU_EDGES             NYUv2-OC++ edge png dir (optional: eps_acc gate)
"""

import os

import numpy as np
import pytest
import torch

KITTI_DATA = os.environ.get("WMD_KITTI_DATA")
KITTI_WEIGHTS = os.environ.get("WMD_KITTI_WEIGHTS")
KITTI_ODOM_DATA = os.environ.get("WMD_KITTI_ODOM_DATA")
KITTI_POSE_WEIGHTS = os.environ.get("WMD_KITTI_POSE_WEIGHTS")
NYU_MAT = os.environ.get("WMD_NYU_MAT")
NYU_SPLITS = os.environ.get("WMD_NYU_SPLITS")
NYU_WEIGHTS = os.environ.get("WMD_NYU_WEIGHTS")
NYU_EDGES = os.environ.get("WMD_NYU_EDGES")


def _device() -> str:
    """The card when one is visible, else the CPU; printed with the gate's
    output."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"gate runs on {dev} ({name})")
    return dev


def _eigen_argv(weights, num_layers, height, width, dev):
    return ["--data_path", KITTI_DATA, "--torch_model_path", weights,
            "--eval_stereo", "--use_wavelets", "--num_layers",
            str(num_layers), "--height", str(height), "--width", str(width),
            "--device", dev]


def _eigen_metrics(weights, num_layers, height, width):
    """Dense eigen-split eval with reference weights: abs_rel, rmse, a1."""
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth
    res = evaluate_depth.main(_eigen_argv(weights, num_layers, height,
                                          width, _device()))
    m = res["metrics"]
    return m["abs_rel"], m["rmse"], m["a1"]


# README.md:81-84 rows: (env var, layers, h, w, abs_rel, rmse, a1)
_KITTI_ROWS = [
    ("WMD_KITTI_WEIGHTS_R50", 50, 192, 640, 0.105, 4.625, 0.879),
    ("WMD_KITTI_WEIGHTS_R18_1024", 18, 320, 1024, 0.102, 4.452, 0.890),
    ("WMD_KITTI_WEIGHTS_R50_1024", 50, 320, 1024, 0.097, 4.387, 0.891),
]


@pytest.mark.parametrize("env,layers,h,w,abs_rel,rmse,a1", _KITTI_ROWS,
                         ids=[r[0] for r in _KITTI_ROWS])
def test_eigen_table_rows_match_published(env, layers, h, w, abs_rel,
                                          rmse, a1):
    """Golden gates for the remaining KITTI README rows
    (`README.md:82-84`): R50 640x192 and both 1024x320 configs."""
    weights = os.environ.get(env)
    if not (KITTI_DATA and weights):
        pytest.skip(f"KITTI data / {env} not available")
    got = _eigen_metrics(weights, layers, h, w)
    assert abs(got[0] - abs_rel) < 0.005
    assert abs(got[1] - rmse) < 0.15
    assert abs(got[2] - a1) < 0.01


@pytest.mark.skipif(not (KITTI_DATA and KITTI_WEIGHTS),
                    reason="KITTI data/weights not available")
def test_eigen_dense_eval_matches_published():
    """Golden gate: ResNet18 640x192 stereo+hints dense decode on the
    eigen split must land within noise of README.md:81
    (abs_rel 0.106, RMSE 4.693, a1 0.876)."""
    abs_rel, rmse, a1 = _eigen_metrics(KITTI_WEIGHTS, 18, 192, 640)
    assert abs(abs_rel - 0.106) < 0.005
    assert abs(rmse - 4.693) < 0.15
    assert abs(a1 - 0.876) < 0.01


@pytest.mark.skipif(not (KITTI_DATA and KITTI_WEIGHTS),
                    reason="KITTI data/weights not available")
def test_sparse_score_loss_within_claim():
    """Paper claim (README.md:97): <=1.4% relative score loss at ~10%
    density with sparse decoding, on the first 100 eigen frames."""
    from wavelet_monodepth_tpu_torch.data.splits import readlines
    from wavelet_monodepth_tpu_torch.eval import kitti_eval
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed

    dev = _device()
    opts, _ = ed.parse_args(_eigen_argv(KITTI_WEIGHTS, 18, 192, 640, dev)
                            + ["--use_sparse"])
    files = readlines(os.path.join(KITTI_DATA, "splits", "eigen",
                                   "test_files.txt"))[:100]
    forward = ed.load_forward(opts, torch.device(dev), KITTI_WEIGHTS)
    ds = ed.eval_dataset(opts, files)
    dense_disps, _ = kitti_eval.predict_disps(
        forward, ed.eval_batches(opts, ds), device=dev)
    sparse_disps, info = kitti_eval.predict_disps(
        forward, ed.eval_batches(opts, ds), device=dev,
        sparse_threshold=0.05)
    gt = np.load(os.path.join(KITTI_DATA, "splits", "eigen",
                              "gt_depths.npz"),
                 fix_imports=True, encoding="latin1",
                 allow_pickle=True)["data"][:100]
    dense_err, _ = kitti_eval.evaluate_disps(dense_disps, gt,
                                             eval_stereo=True)
    sparse_err, _ = kitti_eval.evaluate_disps(sparse_disps, gt,
                                              eval_stereo=True)
    rel_loss = (sparse_err[0] - dense_err[0]) / dense_err[0]
    assert rel_loss < 0.02
    assert info["density_mean"] < 0.2


@pytest.mark.skipif(not (NYU_MAT and NYU_SPLITS and NYU_WEIGHTS),
                    reason="NYU data/weights not available")
def test_nyu_densenet161_matches_published():
    """Golden gate: DenseNet161 DecoderWave on the 654-image labeled
    test set must land within noise of README.md:131 (abs_rel 0.1258,
    rmse 0.5515, delta1 0.8451; eps_acc 1.8070 when NYUv2-OC++ edges are
    mounted)."""
    from wavelet_monodepth_tpu_torch.tools.evaluate_nyu import main
    argv = ["--data_path", NYU_MAT, "--splits_path", NYU_SPLITS,
            "--torch_model_path", NYU_WEIGHTS, "--encoder_type",
            "densenet", "--use_wavelets", "--device", _device()]
    if NYU_EDGES:
        argv += ["--edges_dir", NYU_EDGES]
    res = main(argv)
    assert abs(res["abs_rel"] - 0.1258) < 0.003
    assert abs(res["rmse"] - 0.5515) < 0.01
    assert abs(res["a1"] - 0.8451) < 0.005
    if NYU_EDGES:
        assert abs(res["eps_acc"] - 1.8070) < 0.1


@pytest.mark.skipif(not (KITTI_ODOM_DATA and KITTI_POSE_WEIGHTS),
                    reason="KITTI odometry data / pose weights missing")
@pytest.mark.parametrize("split,max_ate", [("odom_9", 0.05),
                                           ("odom_10", 0.05)])
def test_odometry_ate_within_range(split, max_ate):
    """Golden gate: 5-frame-track ATE on odom 09/10 with reference pose
    weights. The reference publishes no odometry table; the bound is the
    monodepth2-lineage operating range (ATE ~0.017 +- 0.01,
    `KITTI/evaluate_pose.py:23-134`): a wiring and convention check."""
    from wavelet_monodepth_tpu_torch.tools.evaluate_pose import main
    res = main(["--data_path", KITTI_ODOM_DATA, "--eval_split", split,
                "--torch_model_path", KITTI_POSE_WEIGHTS,
                "--device", _device()])
    ate = res["ate_mean"]
    assert np.isfinite(ate) and 0 < ate < max_ate


def test_canny_matches_skimage_ab():
    """The port's exact Canny against scikit-image's (<=0.18 semantics)
    on structured + random images. Runs wherever skimage is installed;
    tests/test_torch_port_nyu_eval.py holds it to JAX's."""
    skimage = pytest.importorskip("skimage")
    from skimage.feature import canny as sk_canny
    from wavelet_monodepth_tpu_torch.eval.nyu_eval import canny

    assert skimage
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:96, 0:128]
    images = [
        (xx > 64).astype(float),
        ((xx - 64) ** 2 + (yy - 48) ** 2 < 900).astype(float),
        np.sin(xx / 7.0) * np.cos(yy / 9.0),
        rng.rand(96, 128),
    ]
    for i, img in enumerate(images):
        theirs = sk_canny(img, sigma=np.sqrt(2), low_threshold=0.15,
                          high_threshold=0.3)
        np.testing.assert_array_equal(canny(img), theirs,
                                      err_msg=f"image {i}")


def test_gates_hold_jax_targets_and_mounts():
    """The port's gates read JAX's environment variables and hold the same
    published rows, and golden_check vets exactly those mounts."""
    import test_integration_data as jgates
    from wavelet_monodepth_tpu.tools import golden_check as jgc
    from wavelet_monodepth_tpu_torch.tools import golden_check as tgc

    assert _KITTI_ROWS == jgates._KITTI_ROWS
    for name in ("KITTI_DATA", "KITTI_WEIGHTS", "KITTI_ODOM_DATA",
                 "KITTI_POSE_WEIGHTS", "NYU_MAT", "NYU_SPLITS",
                 "NYU_WEIGHTS", "NYU_EDGES"):
        assert globals()[name] == getattr(jgates, name)
    assert [m[:2] for m in tgc.MOUNTS] == [m[:2] for m in jgc.MOUNTS]
