"""Port parity, the NYUv2 evaluation: `eval/nyu_eval.py` and
`tools/evaluate_nyu.py` of wavelet_monodepth_tpu_torch against the JAX
package's.

  * the host scoring (skimage-exact Canny, the truncated chamfer
    boundary errors, the six-metric row) equal to JAX's on the same
    arrays;
  * `predict_depth_batch` / `evaluate` with one model on both sides (a
    fixed function of the image, written twice) at 480x640 and 224x224,
    in metric and --disparity modes, edges included: depths and rows
    within 1e-4;
  * `save_outputs_pickle`'s keys and values;
  * `evaluate_nyu.main` end to end against JAX's `main` on an h5py
    `.mat` fixture (2 test images), DenseNet161 + NyuDecoderWave at
    480x640 with edges, weights in a reference `model.pth` written by
    JAX's exporter: the printed rows agree within 1e-4, the edge
    metrics within 1e-3 px (Canny thresholds flip a few pixels of
    predictions ~1e-6 m apart);
  * --bfloat16 against JAX's bf16 forward on the same weights.

Synthetic frames: smooth random colour and piecewise-constant depth in
[1, 9] m with GT edges from Canny on the normalised depth.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_nyu_models import random_vars
from wavelet_monodepth_tpu.eval import nyu_eval as jne
from wavelet_monodepth_tpu.models.decoders_nyu import NyuDecoderWave as JWave
from wavelet_monodepth_tpu.models.densenet import DenseNet161Encoder as JDense
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.utils.precision import cast_floats as jcast
from wavelet_monodepth_tpu.utils.precision import wrap_forward_bf16 as jwrap
from wavelet_monodepth_tpu_torch.eval import nyu_eval as tne
from wavelet_monodepth_tpu_torch.tools import evaluate_nyu as tev

torch.set_num_threads(2)
N_FRAMES = 3


def _frames(n: int, seed: int = 0):
    """(rgb uint8 (n, 480, 640, 3), depth float32 (n, 480, 640) in m,
    GT edges bool)."""
    rng = np.random.RandomState(seed)
    rgb = np.empty((n, 480, 640, 3), np.uint8)
    depth = np.empty((n, 480, 640), np.float32)
    for i in range(n):
        low = rng.rand(12, 16, 3)
        rgb[i] = (255 * np.kron(low, np.ones((40, 40, 1)))
                  * (0.8 + 0.2 * rng.rand(480, 640, 3))).astype(np.uint8)
        d = np.full((480, 640), 1.0 + 8.0 * rng.rand(), np.float32)
        for _ in range(4):
            y, x = rng.randint(0, 400), rng.randint(0, 560)
            d[y:y + rng.randint(40, 200), x:x + rng.randint(40, 300)] = \
                1.0 + 8.0 * rng.rand()
        depth[i] = d
    edges = np.stack([jne.canny((d - d.min()) / (d.max() - d.min()))
                      for d in depth])
    return rgb, depth, edges


@pytest.fixture(scope="module")
def frames():
    return _frames(N_FRAMES)


def _toy_jax(disparity: bool):
    """A fixed model in JAX: ("disp", 0) from the image's grey level,
    at H/2 for a 480x640 input and full size at 224 (the 224 decoders'
    output): depth in cm, or DepthNorm disparity."""
    def forward(x, thresh=None):
        g = x.mean(-1, keepdims=True)
        if x.shape[1] == 480:
            g = g.reshape(x.shape[0], 240, 2, 320, 2, 1).mean(axis=(2, 4))
        d = 1.0 + 8.0 * g
        return {("disp", 0): 0.1 / d if disparity else 100.0 * d}
    return forward


def _toy_torch(disparity: bool):
    def forward(x, thresh=None):
        g = x.mean(-1, keepdim=True)
        if x.shape[1] == 480:
            g = g.reshape(x.shape[0], 240, 2, 320, 2, 1).mean(dim=(2, 4))
        d = 1.0 + 8.0 * g
        return {("disp", 0): 0.1 / d if disparity else 100.0 * d}
    return forward


# --- host scoring ------------------------------------------------------------

def test_canny_and_errors_equal_jax(frames):
    rgb, depth, edges = frames
    rng = np.random.RandomState(1)
    for i in range(N_FRAMES):
        img = rgb[i].mean(-1) / 255.0
        for lo, hi in ((0.15, 0.3), (0.05, 0.1)):
            np.testing.assert_array_equal(
                tne.canny(img, low_threshold=lo, high_threshold=hi),
                jne.canny(img, low_threshold=lo, high_threshold=hi))
        np.testing.assert_array_equal(tne.canny(np.zeros((20, 30))),
                                      jne.canny(np.zeros((20, 30))))
        pred = depth[i] * (1 + 0.1 * rng.rand(480, 640)).astype(np.float32)
        assert tne.compute_errors_nyu(depth[i], pred) == \
            jne.compute_errors_nyu(depth[i], pred)
        pred[:5, :5] = 0.0        # invalid pixels, NaN in the normalisation
        for mask in (None, rng.rand(480, 640) > 0.2):
            ours = tne.compute_depth_boundary_error(edges[i], pred, mask)
            ref = jne.compute_depth_boundary_error(edges[i], pred, mask)
            assert ours[:2] == ref[:2]
            np.testing.assert_array_equal(ours[2], ref[2])
        no_edges = tne.compute_depth_boundary_error(
            np.zeros_like(edges[i]), pred)
        assert np.isnan(no_edges[0]) and np.isnan(no_edges[1])


# --- the pipeline ------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((448, 608), (480, 640)),
                                     ((240, 320), (224, 304)),
                                     ((240, 320), (480, 640))])
def test_align_corners_resize_equals_jax(src, dst):
    """The eval's resizes: F.interpolate(align_corners=True) against JAX's
    interpolation-matrix einsums, up and down (no antialiasing), 1e-5."""
    from wavelet_monodepth_tpu.ops.image import resize_bilinear as jresize
    from wavelet_monodepth_tpu_torch.ops.image import resize_bilinear
    x = np.random.RandomState(3).rand(2, *src, 3).astype(np.float32) * 10
    ours = resize_bilinear(torch.from_numpy(x), *dst, align_corners=True)
    ref = jresize(jnp.asarray(x), *dst, align_corners=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("use_224", [False, True])
@pytest.mark.parametrize("disparity", [False, True])
def test_predict_depth_batch_equals_jax(frames, use_224, disparity):
    rgb = frames[0][:2]
    ours, outs = tne.predict_depth_batch(
        _toy_torch(disparity), rgb, disparity, use_224, 0.1,
        return_outputs=True, device="cpu")
    ref = jne.predict_depth_batch(_toy_jax(disparity), rgb, disparity,
                                  use_224, 0.1)
    size = (224, 224) if use_224 else (480, 640)
    assert ours.shape == ref.shape == (2,) + size
    assert ours.min() >= 0.4 and ours.max() <= 10.0
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    one = tne.predict_depth(_toy_torch(disparity), rgb[1], disparity,
                            use_224, device="cpu")
    np.testing.assert_allclose(one, ours[1], atol=1e-5, rtol=0)
    assert isinstance(outs[("disp", 0)], torch.Tensor)


@pytest.mark.parametrize("use_224", [False, True])
@pytest.mark.parametrize("disparity", [False, True])
def test_evaluate_row_equals_jax(frames, use_224, disparity):
    rgb, depth, edges = frames
    edges = None if use_224 else edges
    timings = {}
    ours = tne.evaluate(_toy_torch(disparity), rgb, depth, edges_gt=edges,
                        use_disparity=disparity, use_224=use_224,
                        batch_size=2, device="cpu", timings=timings)
    ref = jne.evaluate(_toy_jax(disparity), rgb, depth, edges_gt=edges,
                       use_disparity=disparity, use_224=use_224,
                       batch_size=2)
    assert set(ours) == set(ref)
    assert set(ours) >= {"abs_rel", "rmse", "log10", "a1", "a2", "a3"}
    assert ("eps_acc" in ours) == (not use_224)
    for k in ref:
        assert np.isfinite(ours[k]), k
        assert abs(ours[k] - ref[k]) <= 1e-4, (k, ours[k], ref[k])
    assert timings["predict_s"] > 0 and timings["edges_s"] >= 0
    with pytest.raises(ValueError, match="480x640"):
        tne.evaluate(_toy_torch(disparity), rgb, depth, edges_gt=frames[2],
                     use_224=True, device="cpu")


@pytest.mark.parametrize("disparity", [False, True])
def test_save_outputs_pickle_equals_jax(tmp_path, disparity):
    rng = np.random.RandomState(2)
    outs = {("disp", 0): rng.rand(1, 240, 320, 1).astype(np.float32),
            ("wavelets", 2, "LL"): rng.rand(1, 60, 80, 1).astype(np.float32)}
    for s in range(3):
        for c in ("LH", "HL", "HH"):
            outs[("wavelets", s, c)] = rng.rand(
                1, 30 * 2 ** (2 - s), 40 * 2 ** (2 - s), 1).astype(np.float32)
    pred = rng.rand(480, 640).astype(np.float32)
    jne.save_outputs_pickle(outs, pred, str(tmp_path / "jax"), 3, disparity)
    tne.save_outputs_pickle({k: torch.from_numpy(v) for k, v in outs.items()},
                            pred, str(tmp_path / "port"), 3, disparity)
    loads = [pickle.load(open(tmp_path / d / "results_3.pickle", "rb"))
             for d in ("jax", "port")]
    assert list(loads[0]) == list(loads[1])
    for k, v in loads[0].items():
        np.testing.assert_array_equal(loads[1][k], v, err_msg=str(k))
    # the reference's in-place /100 of the metric path
    disp = outs[("disp", 0)][0]
    np.testing.assert_array_equal(loads[1][("disp", 0)],
                                  disp if disparity else disp / 100.0)


def test_load_nyu_labeled_without_h5py(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("no h5py")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(RuntimeError, match="h5py"):
        tne.load_nyu_labeled("x.mat", "splits.mat")


# --- the CLI, end to end ----------------------------------------------------

@pytest.fixture(scope="module")
def nyu_mount(tmp_path_factory, frames):
    """nyu_depth_v2_labeled.mat (the v7.3 layout: images (N, 3, W, H),
    depths (N, W, H)), splits.mat selecting 2 of 3 frames, their edge
    PNGs and a DenseNet161 + DecoderWave model.pth from JAX's exporter."""
    import h5py
    from PIL import Image
    from scipy.io import savemat
    root = tmp_path_factory.mktemp("nyu_mount")
    rgb, depth, edges = frames
    data = str(root / "nyu_depth_v2_labeled.mat")
    with h5py.File(data, "w") as f:
        f["images"] = rgb.transpose(0, 3, 2, 1)
        f["depths"] = depth.transpose(0, 2, 1)
    splits = str(root / "splits.mat")
    savemat(splits, {"testNdxs": np.array([[1], [3]]),
                     "trainNdxs": np.array([[2]])})
    edir = root / "edges"
    edir.mkdir()
    for j, i in enumerate((0, 2)):
        Image.fromarray(edges[i].astype(np.uint8) * 255).save(
            edir / f"{j + 1:04d}.png")
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    enc = JDense()
    ev = random_vars(enc.init, x, seed=11)
    feats = jax.eval_shape(enc.apply, ev, x)
    dec = JWave(num_ch_enc=(96, 96, 192, 384, 2208))
    dv = random_vars(dec.init, feats, seed=12)
    # ("disp", 0) keeps the mean of ("disp", 3), the LL head: about 300 cm;
    # quiet high-frequency heads leave a prediction of 8x8 blocks whose
    # Canny edges do not hang on the last float bit
    dv["params"]["wave1_ll"]["bias"] += 300.0
    for k in ("wave1", "wave2", "wave3"):
        dv["params"][k] = {n: 0.01 * v for n, v in dv["params"][k].items()}
    sd = {**jti.export_densenet_encoder(ev), **jti.export_nyu_wave_decoder(dv)}
    model = str(root / "model.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, model)
    return {"argv": ["--data_path", data, "--splits_path", splits,
                     "--encoder_type", "densenet", "--use_wavelets",
                     "--torch_model_path", model],
            "edges": str(edir), "model": model}


def _printed_row(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.strip()]
    keys, vals = lines[-2].split(), lines[-1].split()
    return dict(zip(keys, map(float, vals)))


def test_evaluate_nyu_main_equals_jax(nyu_mount, capsys):
    from wavelet_monodepth_tpu.tools.evaluate_nyu import main as jmain
    argv = nyu_mount["argv"] + ["--edges_dir", nyu_mount["edges"]]
    jmain(argv)
    ref = _printed_row(capsys.readouterr().out)
    result = tev.main(argv + ["--device", "cpu"])
    ours = _printed_row(capsys.readouterr().out)
    assert list(ours) == list(ref) == ["abs_rel", "rmse", "log10", "a1",
                                       "a2", "a3", "eps_acc", "eps_comp"]
    assert np.isfinite(list(ours.values())).all()
    assert 0.0 < ours["a3"] and ours["rmse"] < 10.0
    for k in ref:
        # the edge metrics threshold Canny maps of the two predictions,
        # which differ by ~1e-6 m: 3-4 of ~10k edge pixels flip and move
        # eps by up to ~4e-4 px per image; the host scoring itself is
        # held exact above
        tol = 1e-3 if k.startswith("eps") else 1e-4
        assert abs(ours[k] - ref[k]) <= tol, (k, ours, ref)
        assert abs(result[k] - ours[k]) <= 5e-5, k
    # JAX's importer (and the port's strict load) cover the 480x640
    # DecoderWave only: a 224 DecoderWave224 has no up4 / wave4 there
    with pytest.raises(RuntimeError, match="up4"):
        tev.main(nyu_mount["argv"] + ["--use_224", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tev.main(nyu_mount["argv"][:-2] + ["--load_weights_folder", "w",
                                           "--device", "cpu"])


def test_evaluate_nyu_bfloat16_near_jax_bf16(nyu_mount, frames):
    """--bfloat16: the port's full cast against JAX's (`evaluate_nyu.py:
    116-131`: its importer's numpy weights cast by cast_floats, the
    forward jitted and wrapped) on the same model.pth, one frame through
    predict_depth_batch: depths within 1% of the mean f32 depth on
    average, 5% at most; both within the same bound of the f32 port."""
    args = tev.parse_args(nyu_mount["argv"] + ["--bfloat16", "--device",
                                               "cpu"])
    ours = tne.predict_depth_batch(
        tev.load_forward(tev.nyu_options(args), "cpu",
                         args.torch_model_path), frames[0][:1], device="cpu")
    f32 = tne.predict_depth_batch(
        tev.load_forward(tev.nyu_options(tev.parse_args(
            nyu_mount["argv"] + ["--device", "cpu"])), "cpu",
            args.torch_model_path), frames[0][:1], device="cpu")
    sd = jti.load_pth(nyu_mount["model"])
    ev, dv = (jcast(v, jnp.bfloat16) for v in (
        jti.import_densenet_encoder(sd), jti.import_nyu_wave_decoder(sd)))
    enc, dec = JDense(), JWave(num_ch_enc=(96, 96, 192, 384, 2208))

    @functools.partial(jax.jit, static_argnames=("thresh",))
    def forward(image, thresh=None):
        return dec.apply(dv, enc.apply(ev, image))

    ref = jne.predict_depth_batch(jwrap(forward), frames[0][:1])
    scale = float(f32.mean())
    for other in (ref, f32):
        gap = np.abs(ours - other)
        assert gap.mean() <= 0.01 * scale and gap.max() <= 0.05 * scale, (
            gap.mean(), gap.max(), scale)
