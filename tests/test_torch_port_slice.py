"""Port parity, the serving slice end to end: maskgen, the weight bridge
through a reference checkpoint folder, and tools/infer.py of
wavelet_monodepth_tpu_torch against the JAX package's, at 64x96.

Tolerances: disparity and wavelet outputs 1e-4 (encoder features differ
by f32 reassociation, see test_torch_port_models.py); masks exactly,
except where a computed threshold lies within 1e-5 of max |yh|; the
colormap within 3/255 of matplotlib's magma.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.tools import infer as jinfer
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.utils import maskgen as jmg
from wavelet_monodepth_tpu_torch.tools import infer as tinfer
from wavelet_monodepth_tpu_torch.utils import maskgen as tmg
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96

PORT_PACKAGE = os.path.join(REPO, "wavelet_monodepth_tpu_torch")


def _port_modules() -> list:
    """Every module of the port: the package's .py files (build outputs
    and caches, in directories whose names start with "_", aside)."""
    names = []
    for dirpath, dirnames, files in os.walk(PORT_PACKAGE):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("_"))
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)
                name = rel[:-len(".py")].replace(os.sep, ".")
                names.append(name[:-len(".__init__")]
                             if name.endswith(".__init__") else name)
    return names


PORT_MODULES = _port_modules()


def test_port_imports_no_jax():
    """Importing every port module (and running infer's lazy imports'
    targets) loads neither jax/flax nor the JAX package nor tools_dev, and
    no cv2, sklearn or matplotlib (the card's machine has none of them;
    the plot tool imports matplotlib when it draws)."""
    assert {"wavelet_monodepth_tpu_torch.parallel.mesh",
            "wavelet_monodepth_tpu_torch.parallel.spatial_hints",
            "wavelet_monodepth_tpu_torch.tools.k6_variants",
            "wavelet_monodepth_tpu_torch.tools.phase_ab",
            "wavelet_monodepth_tpu_torch.tools.self_golden",
            "wavelet_monodepth_tpu_torch.tools.soak_nyu",
            "wavelet_monodepth_tpu_torch.tools.infer",
            "wavelet_monodepth_tpu_torch"} <= set(PORT_MODULES)
    code = (
        "import sys, importlib\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "import PIL.Image\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'wavelet_monodepth_tpu', 'tools_dev', "
        "'cv2', 'sklearn', 'matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the chip smoke exits non-zero and prints no result;
    alone in a directory (no port package) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), None)):
        if script is None:
            script = str(tmp_path / "chip_smoke.py")
            with open(os.path.join(REPO, "chip_smoke.py")) as f, \
                    open(script, "w") as g:
                g.write(f.read())
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=300,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_kernel_ab_refuses_without_a_card():
    """The tree A/B timer needs a card: its run of a tree fails, and it
    prints no summary."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = os.path.join(REPO, "wavelet_monodepth_tpu_torch", "tools",
                          "kernel_ab.py")
    proc = subprocess.run([sys.executable, script, REPO], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr
    assert "summary" not in proc.stdout


def test_k2_phases_instruments_every_phase():
    """The phase timer's copy of K2 reads the clock before phase A and
    after each of the four phases' barriers, and exports the readings."""
    from wavelet_monodepth_tpu_torch.tools import k2_phases
    src = open(os.path.join(REPO, "wavelet_monodepth_tpu_torch", "csrc",
                            "fused_wave_stage.cu")).read()
    out = k2_phases.instrument(src)
    assert [out.count(f"clk[{k}] = clock64();") for k in range(5)] == [1] * 5
    assert "int k2_clocks(long long* host)" in out
    assert out.replace("\n", "").count("run_phase<") == src.count(
        "run_phase<")
    with pytest.raises(RuntimeError, match="phase calls"):
        k2_phases.instrument(src.replace("  run_phase<", "  phase<"))


def test_k2_phases_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = os.path.join(REPO, "wavelet_monodepth_tpu_torch", "tools",
                          "k2_phases.py")
    proc = subprocess.run([sys.executable, script], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr


def test_maskgen_matches_jax():
    disp_j = jmg.synthetic_depth_scene(2, H, W, seed=4)
    disp_t = tmg.synthetic_depth_scene(2, H, W, seed=4)
    np.testing.assert_array_equal(disp_t, disp_j)
    np.testing.assert_array_equal(tmg.scene_image(disp_t, seed=4),
                                  jmg.scene_image(disp_j, seed=4))
    mt = tmg.dwt_stage_masks(disp_t, 0.05)
    mj = jmg.dwt_stage_masks(disp_j, 0.05)
    for i in (1, 2, 3):
        np.testing.assert_array_equal(mt[i], mj[i], err_msg=str(i))
    assert tmg.aggregate_density(mt, H, W) == jmg.aggregate_density(mj, H, W)
    masks_t, ratio_t, dens_t = tmg.masks_at_density(disp_t, 0.10)
    masks_j, ratio_j, dens_j = jmg.masks_at_density(disp_j, 0.10)
    assert (ratio_t, dens_t) == (ratio_j, dens_j)
    for i in masks_j:
        np.testing.assert_array_equal(masks_t[i], masks_j[i])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference-layout checkpoint folder written by the JAX package's
    exporter (random JAX weights), plus 2 scene images at 80x120."""
    root = tmp_path_factory.mktemp("slice")
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    enc, dec = JEncoder(num_layers=18), JDecoder(num_ch_enc=j_num_ch_enc(18))
    ev = enc.init(jax.random.PRNGKey(0), x)
    dv = dec.init(jax.random.PRNGKey(1), enc.apply(ev, x))
    folder = root / "weights"
    folder.mkdir()
    enc_sd = jti.export_resnet_encoder(
        ev, meta={"height": H, "width": W, "use_stereo": 1})
    dec_sd = jti.export_kitti_wavelet_decoder(dv)
    to_t = (lambda sd: {k: torch.from_numpy(np.array(v))
                        if isinstance(v, np.ndarray) else v
                        for k, v in sd.items()})
    torch.save(to_t(enc_sd), folder / "encoder.pth")
    torch.save(to_t(dec_sd), folder / "depth.pth")
    disp = tmg.synthetic_depth_scene(2, 80, 120, seed=5)
    imgs = (tmg.scene_image(disp, seed=5) * 255).astype(np.uint8)
    for k in range(2):
        Image.fromarray(imgs[k]).save(root / f"scene_{k}.png")
    return root


def _args(checkpoint, **kw):
    ns = vars(jinfer.parse_args(["--image_path", str(checkpoint),
                                 "--torch_model_path",
                                 str(checkpoint / "weights")]))
    ns.update(kw)
    return SimpleNamespace(**ns)


def test_preprocess_matches_jax_infer(checkpoint):
    x, size = tinfer.preprocess_image(str(checkpoint / "scene_0.png"), W, H)
    img = Image.open(checkpoint / "scene_0.png").convert("RGB")
    ref = np.asarray(img.resize((W, H), Image.LANCZOS), np.float32) / 255.0
    assert size == (120, 80) and x.shape == (1, H, W, 3)
    np.testing.assert_array_equal(x[0], ref)


@pytest.mark.parametrize("backend", [False, True, "pallas2d"])
def test_served_forward_matches_jax(checkpoint, backend):
    """infer.load_model's forward, dense and sparse at threshold 0.1, on
    each sparse backend, against the JAX package's model.

    Sparse: the JAX decoder reruns under the port's raw masks
    (mask_override), so every stage sees the same history. Each port mask
    pixel must then equal JAX's own threshold decision on that run, or lie
    where max |yh| is within 1e-5 of the threshold; disp agrees within
    1e-4, every mask and op count exactly."""
    enc, dec, ev, dv, *_ = jinfer.load_variables(_args(checkpoint))
    fwd_j, feed_j = jinfer.load_model(_args(checkpoint))
    fwd_t, feed_t = tinfer.load_model(_args(checkpoint), "cpu",
                                      use_pallas=backend)
    assert feed_t == feed_j == (H, W)
    x, _ = tinfer.preprocess_image(str(checkpoint / "scene_1.png"), W, H)
    ours = fwd_t(torch.from_numpy(x), None)
    ref = fwd_j(jnp.asarray(x), None)
    for s in range(4):
        np.testing.assert_allclose(ours[("disp", s)].numpy(),
                                   np.asarray(ref[("disp", s)]),
                                   atol=1e-4, err_msg=f"dense disp {s}")

    thresh = 0.1
    ours = fwd_t(torch.from_numpy(x), thresh)
    raw = {i: ours[("wavelet_mask", i - 1)][:, ::2, ::2].numpy()
           for i in (1, 2, 3)}
    ref = dec.apply(dv, enc.apply(ev, jnp.asarray(x)), thresh_ratio=thresh,
                    mask_override={i: jnp.asarray(m) for i, m in raw.items()})
    for i in (1, 2, 3):     # scale i thresholds scale i+1's yh
        yl = np.asarray(ref[("wavelets", i - 1, "LL")])
        yh = np.concatenate([np.asarray(ref[("wavelets", i, b)])
                             for b in ("LH", "HL", "HH")], -1)
        t = (yl.max(axis=(1, 2, 3)) - yl.min(axis=(1, 2, 3))) * thresh
        peak = np.abs(yh).max(-1, keepdims=True)
        margin = np.abs(peak - t[:, None, None, None])
        decided = (peak > t[:, None, None, None]).astype(np.float32)
        assert ((raw[i] == decided) | (margin < 1e-5)).all(), f"scale {i}"
    for k in ref:
        if k[0].endswith("mask") or k[0] == "total_ops":
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                          err_msg=str(k))
    for s in range(4):
        np.testing.assert_allclose(ours[("disp", s)].numpy(),
                                   np.asarray(ref[("disp", s)]),
                                   atol=1e-4, err_msg=f"sparse disp {s}")


def test_infer_main_files_match_jax(checkpoint, tmp_path):
    """Both CLIs over a copy of the image folder: same files, _disp.npy
    and wavelet .npys within 1e-4, a readable jpeg of the original size."""
    outs = {}
    for name, mod in (("jax", jinfer), ("port", tinfer)):
        d = tmp_path / name
        d.mkdir()
        for k in range(2):
            (d / f"scene_{k}.png").write_bytes(
                (checkpoint / f"scene_{k}.png").read_bytes())
        argv = ["--image_path", str(d), "--torch_model_path",
                str(checkpoint / "weights")]
        if mod is tinfer:
            mod.main(argv, device="cpu")
        else:
            mod.main(argv)
        outs[name] = d
    files = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == files
    assert "scene_0_disp.npy" in files and "scene_1_disp.jpeg" in files
    for f in files:
        if f.endswith(".npy"):
            a = np.load(outs["port"] / f)
            b = np.load(outs["jax"] / f)
            assert a.shape == b.shape, f
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f)
    assert Image.open(outs["port"] / "scene_0_disp.jpeg").size == (120, 80)


def test_colormap_close_to_matplotlib_magma():
    """The port carries matplotlib's table and mapping: equal colours."""
    d = np.random.RandomState(6).rand(30, 40).astype(np.float32)
    ours = tinfer.colormap_disp(d)
    ref = jinfer.colormap_disp(d)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_colormap_equals_matplotlib_at_ties(dtype):
    """Ties at vmin and at the 95th-percentile vmax, values above vmax,
    and a constant image."""
    rng = np.random.RandomState(7)
    d = (np.round(rng.rand(40, 50) * 8) / 8 * 3.7 + 0.3).astype(dtype)
    d[:5] = d.min()
    assert (d == np.percentile(d, 95)).any()
    for img in (d, np.full((6, 7), 2.5, dtype)):
        np.testing.assert_array_equal(tinfer.colormap_disp(img),
                                      jinfer.colormap_disp(img))


def test_infer_rejects_unported_inputs(checkpoint):
    with pytest.raises(SystemExit, match="flax"):
        tinfer.load_model(_args(checkpoint, torch_model_path=None,
                                model_path="x"), "cpu")
    # bfloat16 serves on every backend but the tile-sparse conv's, which
    # the JAX package cannot lower in bfloat16
    for backend in (True, "pallas2d"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tinfer.load_model(_args(checkpoint, bfloat16=True), "cpu",
                              backend)
