"""Port parity, the NYUv2 training inputs: the port's expand_nyu, zip
loader (its shuffled order, NyuDepthDataset items of every transform and
feed, 8-bit and 16-bit depth PNGs, batch_iterator), fabricate_nyu with
its cv2-free INTER_AREA, and the auxiliary NYU losses, against the JAX
package's on the CPU.

Tolerances: expand_nyu, the items, the order and batches, the resize and
the fabricated csv and depth PNGs exactly (the same PIL and numpy
operations; the resize emulates OpenCV's fixed point); the fabricated
RGB within a mean of 2 grey levels (the renderer's texture takes
OpenCV's INTER_CUBIC in JAX and a float emulation of it in the port, so
its views differ by at most 1 grey level at a few pixels); the losses
within 1e-6 (float32 sums in another order).
"""

import io
import random
import zipfile

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wavelet_monodepth_tpu.data import nyu as jnyu
from wavelet_monodepth_tpu.data import synth as jsynth
from wavelet_monodepth_tpu.ops import augment as jaug
from wavelet_monodepth_tpu.train import losses_nyu as jlosses
from wavelet_monodepth_tpu_torch.data import nyu as tnyu
from wavelet_monodepth_tpu_torch.data import synth as tsynth
from wavelet_monodepth_tpu_torch.ops import augment as taug
from wavelet_monodepth_tpu_torch.ops.resize import resize_area_u8
from wavelet_monodepth_tpu_torch.train import losses_nyu as tlosses

torch.set_num_threads(1)


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def nyu_zip(tmp_path_factory):
    """4 rows at 640x480: smooth RGB, depth PNGs in 8 bits (rows 0-2) and
    in 16 bits of millimetres (row 3)."""
    path = tmp_path_factory.mktemp("nyu_data") / "nyu_data.zip"
    rng = np.random.RandomState(3)
    rows = []
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(4):
            low = rng.rand(12, 16, 3)
            img = cv2.resize(low, (640, 480), interpolation=cv2.INTER_CUBIC)
            img = np.clip(img * 255 + rng.rand(480, 640, 3) * 20, 0,
                          255).astype(np.uint8)
            ramp = np.linspace(0, 1, 480)[:, None] + rng.rand(480, 640) * .1
            dep = ((ramp * 250 + 2).astype(np.uint8) if i < 3 else
                   (ramp * 9000 + 500).astype(np.uint16))
            zf.writestr(f"data/img_{i}.png", _png(img))
            zf.writestr(f"data/dep_{i}.png", _png(dep))
            rows.append(f"data/img_{i}.png,data/dep_{i}.png")
        zf.writestr("data/nyu2_train.csv", "\n".join(rows))
    return str(path)


def test_expand_nyu_is_bitwise_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (2, 8, 12, 3)).astype(np.uint8)
    dep = rng.randint(0, 256, (2, 4, 6, 1)).astype(np.uint8)
    ti, td = taug.expand_nyu(torch.from_numpy(img), torch.from_numpy(dep))
    for xp, conv in ((np, np.asarray), (jnp, jnp.asarray)):
        ji, jd = jaug.expand_nyu(conv(img), conv(dep), xp)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert ti.dtype == td.dtype == torch.float32
    # float inputs pass through, and the eval signature returns the image
    f = torch.from_numpy(rng.rand(1, 4, 4, 3).astype(np.float32))
    d = torch.full((1, 2, 2, 1), 3.0)
    out_i, out_d = taug.expand_nyu(f, d)
    assert out_i is f and out_d is d
    assert torch.equal(taug.expand_nyu(torch.from_numpy(img)), ti)


def test_shuffled_order_equals_jax_and_sklearn(tmp_path):
    from sklearn.utils import shuffle
    path = tmp_path / "rows.zip"
    names = [[f"data/img_{i}.png", f"data/dep_{i}.png"] for i in range(37)]
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("data/nyu2_train.csv",
                    "\n".join(",".join(r) for r in names) + "\n")
    _, jrows = jnyu.load_zip_to_mem(str(path))
    _, trows = tnyu.load_zip_to_mem(str(path))
    assert trows == jrows == shuffle(names, random_state=0)
    assert trows != names


def _rng_draws(seed: int):
    """(flip, channel swap) decided by the train transform's first draws."""
    r = random.Random(seed)
    return r.random() < 0.5, r.random() < 0.1


# (is_train, is_test, is_224, uint8_feed)
CONFIGS = [(True, False, False, True), (True, False, False, False),
           (False, False, False, True), (False, True, False, False),
           (False, True, False, True), (True, False, True, True)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(
    n for n, v in zip(("train", "test", "224", "u8"), c) if v) or "plain")
def test_dataset_items_are_bitwise_jax(nyu_zip, cfg):
    is_train, is_test, is_224, uint8_feed = cfg
    jdata, jpairs = jnyu.load_zip_to_mem(nyu_zip)
    tdata, tpairs = tnyu.load_zip_to_mem(nyu_zip)
    kw = dict(is_train=is_train, is_test=is_test, is_224=is_224,
              uint8_feed=uint8_feed)
    jds = jnyu.NyuDepthDataset(jdata, jpairs, **kw)
    tds = tnyu.NyuDepthDataset(tdata, tpairs, **kw)
    seeds = [0]
    if is_train:   # seeds that cover both flips and two channel swaps
        swaps = [s for s in range(200) if _rng_draws(s)[1]][:2]
        seeds = list(range(4)) + swaps
        assert {_rng_draws(s)[0] for s in seeds} == {True, False}
    for idx in range(len(tds)):
        for s in seeds:
            j = jds.item(idx, random.Random(s))
            t = tds.item(idx, random.Random(s))
            assert set(j) == set(t) == {"image", "depth"}
            for k in j:
                assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
                np.testing.assert_array_equal(t[k], j[k],
                                              err_msg=f"{idx} {s} {k}")


def test_uint8_feed_expands_to_the_float_feed(nyu_zip):
    """The uint8 feed, expanded on the device, gives the float feed's
    bits for 8-bit depth maps."""
    data, pairs = tnyu.load_zip_to_mem(nyu_zip)
    u8 = tnyu.NyuDepthDataset(data, pairs, uint8_feed=True)
    fl = tnyu.NyuDepthDataset(data, pairs, uint8_feed=False)
    for idx in range(len(u8)):
        a, b = u8.item(idx, random.Random(5)), fl.item(idx, random.Random(5))
        img, dep = taug.expand_nyu(torch.from_numpy(a["image"][None].copy()),
                                   torch.from_numpy(a["depth"][None].copy()))
        np.testing.assert_array_equal(img[0].numpy(), b["image"])
        np.testing.assert_array_equal(dep[0].numpy(), b["depth"])


def test_batch_iterator_and_get_training_testing_data(nyu_zip):
    jtrain, jtest = jnyu.get_training_testing_data(nyu_zip, uint8_feed=True)
    ttrain, ttest = tnyu.get_training_testing_data(nyu_zip, uint8_feed=True)
    assert ttrain.pairs == jtrain.pairs == ttest.pairs
    assert ttrain.is_train and not ttest.is_train
    for jds, tds in ((jtrain, ttrain), (jtest, ttest)):
        jb = jnyu.batch_iterator(jds, 2, epochs=2)
        tb = tnyu.batch_iterator(tds, 2, epochs=2)
        for j, t in zip(jb, tb):
            for k in j:
                np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(ValueError, match="no batch"):
        next(tnyu.batch_iterator(ttrain, 5))


def test_resize_area_u8_is_opencv():
    rng = np.random.RandomState(9)
    x = rng.randint(0, 256, (37, 101, 3)).astype(np.uint8)
    for w, h in ((50, 80), (60, 41), (33, 90), (101, 38), (150, 20)):
        np.testing.assert_array_equal(
            resize_area_u8(x, w, h),
            cv2.resize(x, (w, h), interpolation=cv2.INTER_AREA),
            err_msg=str((w, h)))
    np.testing.assert_array_equal(
        resize_area_u8(x[..., 0], 60, 41),
        cv2.resize(x[..., 0], (60, 41), interpolation=cv2.INTER_AREA))
    with pytest.raises(ValueError, match="area average"):
        resize_area_u8(x, 50, 20)


def test_fabricate_nyu_matches_jax(tmp_path):
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    assert jsynth.fabricate_nyu(jpath, n_train=3) == {"zip": jpath,
                                                      "n_train": 3}
    assert tsynth.fabricate_nyu(tpath, n_train=3) == {"zip": tpath,
                                                      "n_train": 3}
    with zipfile.ZipFile(jpath) as jz, zipfile.ZipFile(tpath) as tz:
        assert tz.namelist() == jz.namelist()
        assert tz.read("data/nyu2_train.csv") == jz.read(
            "data/nyu2_train.csv")
        for name in jz.namelist():
            if not name.endswith(".png"):
                continue
            j = Image.open(io.BytesIO(jz.read(name)))
            t = Image.open(io.BytesIO(tz.read(name)))
            assert t.mode == j.mode and t.size == j.size == (640, 480)
            j, t = np.asarray(j).astype(int), np.asarray(t).astype(int)
            if "/dep_" in name:
                np.testing.assert_array_equal(t, j, err_msg=name)
            else:
                assert np.abs(t - j).mean() <= 2.0, name
                assert np.abs(t - j).max() <= 1, name


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.RandomState(4)
    a = rng.rand(2, 24, 20, 3).astype(np.float32)
    b = (a + 0.2 * rng.randn(2, 24, 20, 3)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("window_size", [11, 5, 30])
def test_ssim_windowed_matches_jax(loss_inputs, size_average, window_size):
    a, b = loss_inputs
    j = jlosses.ssim_windowed(jnp.asarray(a), jnp.asarray(b), 1.0,
                              window_size=window_size,
                              size_average=size_average, full=True)
    t = tlosses.ssim_windowed(torch.from_numpy(a), torch.from_numpy(b), 1.0,
                              window_size=window_size,
                              size_average=size_average, full=True)
    for tv, jv in zip(t, j):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6,
                                   rtol=0)
    same = tlosses.ssim_windowed(torch.from_numpy(a), torch.from_numpy(a), 1.)
    np.testing.assert_allclose(float(same), 1.0, atol=1e-5)


def test_berhu_and_cropped_l1_match_jax(loss_inputs):
    a, b = loss_inputs
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(tlosses.berhu_loss(ta, tb)),
                               float(jlosses.berhu_loss(ja, jb)), atol=1e-6,
                               rtol=0)
    for crop in (0, 2, 5):
        np.testing.assert_allclose(
            float(tlosses.cropped_l1_loss(ta, tb, crop)),
            float(jlosses.cropped_l1_loss(ja, jb, crop)), atol=1e-6, rtol=0)
    # the reference's own example: c = 0.2 * 10, |1| linear, |10| quadratic
    v = tlosses.berhu_loss(torch.zeros(1, 2), torch.tensor([[1.0, 10.0]]))
    np.testing.assert_allclose(float(v), (1.0 + 104 / 4.0) / 2, rtol=1e-6)
