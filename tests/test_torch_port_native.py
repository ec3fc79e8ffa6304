"""Port parity, the native host runtime: wavelet_monodepth_tpu_torch's
data/native_loader.py against the JAX package's binding of the same
`native/wmd_native.cpp`, and tools/evaluate_depth.py --native_decode
against the JAX CLI's native feed.

The JAX binding loads `native/libwmd_native.so` when it was built there
(`native/build.sh`), else the port's build of the same source with the
same flags; the port builds its own copy into its `_build/`. Both run
the one OpenCV decode, so the six functions are compared bit for bit, on
JPEGs written by data/synth.py. The eval rows are compared at 1e-4 (the
disparities differ by float32 reassociation between XLA and ATen,
tests/test_torch_port_eval.py). The native feed is compared with the
JAX native feed only: OpenCV's LANCZOS4 and PIL's LANCZOS differ by
about 1e-3 per pixel.
"""

import glob
import os

import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.data import native_loader as jnl
from wavelet_monodepth_tpu.data import synth as jsynth
from wavelet_monodepth_tpu.tools import evaluate_depth as jed
from wavelet_monodepth_tpu_torch.data import native_loader as tnl
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.layers import init_params
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ted
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
H, W = 64, 96
ARGS = ["--eval_stereo", "--use_wavelets", "--height", str(H), "--width",
        str(W), "--batch_size", "2", "--num_workers", "2"]

pytestmark = pytest.mark.skipif(
    bool(tnl.missing_requirements()),
    reason=f"the native library needs {tnl.missing_requirements()}")


@pytest.fixture(scope="module")
def jax_native():
    """The JAX binding, on native/libwmd_native.so where native/build.sh
    made it, else on the port's build of the same source and flags."""
    if jnl._lib is None:
        jnl.load_library(None if os.path.exists(jnl._LIB_PATH)
                         else str(tnl.build()))
    return jnl


@pytest.fixture(scope="module")
def mount(tmp_path_factory):
    """A data/synth.py mount (1242x375 JPEG): 1 train pair, 3 test
    frames."""
    root = str(tmp_path_factory.mktemp("synth") / "kitti")
    jsynth.fabricate(root, n_train=1, n_val=0, n_test=3, progress=False)
    return root


@pytest.fixture(scope="module")
def jpegs(mount):
    return sorted(glob.glob(os.path.join(mount, "**", "*.jpg"),
                            recursive=True))


def test_build_goes_to_the_package_build_dir():
    """The port builds from native/wmd_native.cpp with native/build.sh's
    flags into its own git-ignored _build/, named by a hash of the source
    and the flags, and writes nothing into native/."""
    native = os.path.dirname(tnl.SOURCE)
    before = sorted(os.listdir(native))
    path = tnl.build()
    assert path.parent == tnl.BUILD_DIR and path.exists()
    assert path.name.startswith("libwmd_native_")
    assert sorted(os.listdir(native)) == before
    with open(os.path.join(native, "build.sh")) as f:
        script = f.read()
    for flag in tnl.CXX_FLAGS + tnl.LINK_FLAGS:
        assert flag in script, flag


@pytest.mark.parametrize("flips", [None, [False, True, False, True]])
def test_decode_matches_jax_bitwise(jax_native, jpegs, flips):
    paths = jpegs[:4]
    for name in ("decode_resize_batch", "decode_resize_batch_u8"):
        ref = getattr(jax_native, name)(paths, H, W, flips=flips,
                                        num_threads=2)
        ours = getattr(tnl, name)(paths, H, W, flips=flips, num_threads=3)
        assert ours.dtype == ref.dtype and ours.shape == (4, H, W, 3)
        np.testing.assert_array_equal(ours, ref)
    # the float feed is the uint8 feed times 1/255, exactly
    u8 = tnl.decode_resize_batch_u8(paths, H, W, flips=flips)
    np.testing.assert_array_equal(
        tnl.decode_resize_batch(paths, H, W, flips=flips),
        u8.astype(np.float32) * np.float32(1 / 255))


def test_pyramid_velodyne_and_haar_match_jax_bitwise(jax_native, jpegs):
    img = tnl.decode_resize_batch(jpegs[:1], 96, 160)[0]
    for a, b in zip(tnl.build_pyramid(img, 3),
                    jax_native.build_pyramid(img, 3)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    rng = np.random.RandomState(2)
    pts = np.zeros((200, 4), np.float32)
    pts[:, 0] = rng.rand(200) * 20 - 2          # some behind the sensor
    pts[:, 1] = rng.randn(200) * 2
    pts[:, 2] = rng.randn(200) * 0.5
    pts[:, 3] = 1
    P = np.array([[0, -100, 0, 160], [0, 0, -100, 48], [1, 0, 0, 0]],
                 np.float64) @ np.eye(4)
    ours = tnl.velodyne_to_depth(pts, P, (96, 320))
    np.testing.assert_array_equal(ours,
                                  jax_native.velodyne_to_depth(pts, P,
                                                               (96, 320)))
    assert (ours > 0).sum() > 0

    x = rng.randn(16, 24).astype(np.float32)
    bands = tnl.haar_dwt2(x)
    for a, b in zip(bands, jax_native.haar_dwt2(x)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tnl.haar_idwt2(*bands),
                                  jax_native.haar_idwt2(*bands))
    np.testing.assert_allclose(tnl.haar_idwt2(*bands), x, atol=1e-5)


def test_missing_file_and_missing_toolchain_raise(tmp_path, monkeypatch):
    with pytest.raises(IOError, match="nope.jpg"):
        tnl.decode_resize_batch([str(tmp_path / "nope.jpg")], 32, 32)
    with pytest.raises(IOError):
        tnl.decode_resize_batch_u8([str(tmp_path / "nope.jpg")], 32, 32)
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "missing_requirements",
                        lambda: ["g++", "libopencv_imgcodecs"])
    with pytest.raises(tnl.NativeUnavailable,
                       match=r"g\+\+, libopencv_imgcodecs") as err:
        tnl.decode_resize_batch([], 32, 32)
    assert err.value.missing == ["g++", "libopencv_imgcodecs"]
    assert not tnl.available()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("weights"))
    g = torch.Generator().manual_seed(5)
    enc = init_params(ResnetEncoder(18), g)
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), g)
    ti.save_reference_checkpoint(folder, enc, dec, H, W)
    return folder


@pytest.mark.parametrize("extra", [[], ["--host_augment"]])
def test_native_eval_matches_jax_native_eval(jax_native, mount, weights,
                                             monkeypatch, extra):
    """tools/evaluate_depth.py --native_decode: the port's row against the
    JAX CLI's (both on the native feed, uint8 by default, float32 under
    --host_augment) within 1e-4; the native batches equal JAX's native
    batches bit for bit."""
    monkeypatch.setenv("WMD_TORCH_MODEL_PATH", weights)
    argv = ["--data_path", mount, "--native_decode"] + ARGS + extra
    ref = jed.main(argv)
    ours = ted.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(list(ours["metrics"].values()),
                               list(ref["metrics"].values()), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ours["ratios"], ref["ratios"], rtol=1e-4)

    opts, _ = ted.parse_args(argv + ["--device", "cpu"])
    from wavelet_monodepth_tpu_torch.data.splits import (readlines,
                                                        resolve_split_dir)
    files = readlines(os.path.join(resolve_split_dir("eigen", mount),
                                   "test_files.txt"))
    ds = ted.eval_dataset(opts, files)
    batches = list(ted.native_batches(opts, ds, files))
    assert [len(b) for b in batches] == [2, 1]
    assert batches[0].dtype == (np.float32 if "--host_augment" in extra
                                else np.uint8)
    decode = (jax_native.decode_resize_batch if "--host_augment" in extra
              else jax_native.decode_resize_batch_u8)
    paths = [ds.get_image_path(ln.split()[0], int(ln.split()[1]),
                               ln.split()[2]) for ln in files]
    np.testing.assert_array_equal(np.concatenate(batches),
                                  decode(paths, H, W))
