"""Port parity, the training visuals: wavelet_monodepth_tpu_torch's
utils/logging.py `log_kitti_visuals` / `log_nyu_visuals` against the JAX
package's through recording writers, and the training CLIs with and
without a writer.

Both packages' images are NHWC. The same outputs go to both (numpy to
JAX, tensors to the port): the same tags in the same order, the same
kinds of record, and equal arrays within 1e-6 (both normalise in numpy
float32; the port's only difference is its host copy). The KITTI set is
the train step's own outputs at 64x96, B=2; the NYU sets are
NyuDecoderWave's outputs on a seeded MobileNetV2 and seeded arrays at
NyuDecoderWave224's keys, with the GT coefficients of each package's
`haar_dwt_J`. The CLIs (64x96 KITTI, 224 NYU, B=2, 2 steps, a log and a
validation batch at every step) give the same losses and checkpoints,
bit for bit on the CPU, with a recording writer (which adds a forward
per log step for the train batch's visuals) and without one.
"""

import io
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_data import write_mount
from test_torch_port_train import FIELDS, _batch
from wavelet_monodepth_tpu.ops.wavelets import haar_dwt_J as j_haar_dwt_J
from wavelet_monodepth_tpu.utils.config import KittiOptions as JOptions
from wavelet_monodepth_tpu.utils.logging import SummaryLogger as JLogger
from wavelet_monodepth_tpu_torch.ops.wavelets import haar_dwt_J
from wavelet_monodepth_tpu_torch.tools import train_kitti, train_nyu
from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
from wavelet_monodepth_tpu_torch.utils.config import KittiOptions
from wavelet_monodepth_tpu_torch.utils.logging import SummaryLogger
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)

# the tags of one image of the stereo + hints wavelet visuals (image j's
# tags end in "/j"), as chip_smoke.py's visuals phase checks them
KITTI_TAGS = {
    "color_0_0", "color_s_0", "color_pred_s_0", "depth_hints_mask0",
    "disp_hints", "color_depth_hint0",
    *(f"{kind}_{s}" for s in range(4) for kind in ("automask", "disp")),
    *(f"{pre}{c}_{s}" for s in range(4) for c in ("LL", "LH", "HL", "HH")
      for pre in ("", "hist_", "min/", "max/"))}
# NyuDecoderWave's (the published 640x480 model's): coefficients at
# scales 0-2, its LL at scale 2 not logged, as chip_smoke.py checks them
NYU_TAGS = {
    "color", "disp_0_gt",
    *(f"disp_{s}_pred" for s in range(4)),
    *(f"{pre}{c}_{s}_{side}" for s in range(3) for c in ("LH", "HL", "HH")
      for pre in ("", "hist_") for side in ("pred", "gt"))}
# NyuDecoderWave224's: a fourth coefficient scale, with its LL
NYU_224_TAGS = NYU_TAGS | {
    f"{pre}{c}_3_{side}" for c in ("LH", "HL", "HH", "LL")
    for pre in ("", "hist_") for side in ("pred", "gt")}


class Recorder:
    """A writer with tensorboardX's add_* calls that keeps them."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, np.float64(value), step))

    def add_image(self, tag, img, step):
        self.calls.append(("image", tag, np.asarray(img), step))

    def add_histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, np.asarray(values), step))

    def close(self):
        pass


def tag_set(calls, kinds=("image", "histogram", "scalar")) -> set:
    """The tags' names without their "/image index" suffix."""
    return {c[1].rsplit("/", 1)[0] for c in calls if c[0] in kinds}


def recording_jax_logger():
    logger = JLogger.__new__(JLogger)
    logger.writers = {"train": Recorder(), "val": Recorder()}
    return logger


def recording_logger():
    return SummaryLogger("unused", writers={"train": Recorder(),
                                            "val": Recorder()})


def assert_same_records(ours, ref):
    assert [c[:2] for c in ours] == [c[:2] for c in ref]
    for a, b in zip(ours, ref):
        assert a[3] == b[3]
        assert np.shape(a[2]) == np.shape(b[2]), a[1]
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-6,
                                   err_msg=a[1])


def test_kitti_visuals_match_jax():
    opts = KittiOptions(**FIELDS, device="cpu")
    setup = KittiTrainSetup(opts)
    state = setup.init_state(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    outputs, _ = setup.eval_step(state, batch,
                                 torch.Generator().manual_seed(0))
    # the loader's feed carries the hint disparity too
    batch[("disp_hint",)] = torch.rand(2, 64, 96, 1,
                                       generator=torch.Generator()
                                       .manual_seed(1))
    ours, ref = recording_logger(), recording_jax_logger()
    ours.log_kitti_visuals("train", batch, outputs, opts, 7)
    ref.log_kitti_visuals(
        "train", {k: v.numpy() for k, v in batch.items()},
        {k: v.numpy() for k, v in outputs.items() if torch.is_tensor(v)},
        JOptions(**FIELDS), 7)
    calls = ours.writers["train"].calls
    assert_same_records(calls, ref.writers["train"].calls)
    assert tag_set(calls) == KITTI_TAGS
    assert sum(c[0] == "image" for c in calls) == 2 * 30
    for kind, tag, value, _ in calls:
        if kind == "image":
            assert value.ndim == 3 and value.shape[0] in (1, 3), tag
            assert np.isfinite(value).all() and value.min() >= 0 \
                and value.max() <= 1, tag
    assert ours.writers["val"].calls == []
    SummaryLogger("unused", writers={}).log_kitti_visuals(
        "train", batch, outputs, opts, 7)        # no writer: a no-op


def _nyu_wave_outputs(n, h, w):
    """NyuDecoderWave's dense outputs on a seeded MobileNetV2 encoder and
    image at (2h, 2w), as numpy."""
    from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
        NyuDecoderWave
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.mobilenetv2 import \
        MobileNetV2Encoder
    g = torch.Generator().manual_seed(2)
    enc = init_params(MobileNetV2Encoder(use_last_layer=False), g).eval()
    dec = init_params(NyuDecoderWave(enc.num_ch_enc), g).eval()
    with torch.no_grad():
        out = dec(enc(torch.rand(n, 2 * h, 2 * w, 3, generator=g)))
    return {k: v.numpy() for k, v in out.items()}


def _nyu_224_outputs(rng, n, h, w):
    """Seeded arrays at NyuDecoderWave224's keys and shapes."""
    outputs = {("disp", s): rng.rand(n, h >> s, w >> s, 1).astype(np.float32)
               for s in range(4)}
    for s in range(4):
        for c in ("LH", "HL", "HH") + (("LL",) if s == 3 else ()):
            outputs[("wavelets", s, c)] = rng.randn(
                n, h >> (s + 1), w >> (s + 1), 1).astype(np.float32)
    return outputs


@pytest.mark.parametrize("decoder", ["wave", "wave224"])
def test_nyu_visuals_match_jax(decoder):
    rng = np.random.RandomState(1)
    n, h, w = 3, 32, 48
    image = rng.rand(n, 2 * h, 2 * w, 3).astype(np.float32)
    depth_n = (rng.rand(n, h, w, 1) * 9 + 1).astype(np.float32)
    outputs = (_nyu_wave_outputs(n, h, w) if decoder == "wave"
               else _nyu_224_outputs(rng, n, h, w))
    ours, ref = recording_logger(), recording_jax_logger()
    tdepth = torch.from_numpy(depth_n)
    ours.log_nyu_visuals("val", torch.from_numpy(image), tdepth,
                         {k: torch.from_numpy(v) for k, v in outputs.items()},
                         haar_dwt_J(tdepth, 4), step=3, max_images=2)
    jdepth = jnp.asarray(depth_n)
    ref.log_nyu_visuals("val", image, depth_n, outputs,
                        j_haar_dwt_J(jdepth, 4), step=3, max_images=2)
    calls = ours.writers["val"].calls
    assert_same_records(calls, ref.writers["val"].calls)
    assert tag_set(calls) == (NYU_TAGS if decoder == "wave"
                              else NYU_224_TAGS)
    assert {c[1].rsplit("/", 1)[1] for c in calls} == {"0", "1"}
    # without GT coefficients or histograms: the predicted images only
    ours, ref = recording_logger(), recording_jax_logger()
    ours.log_nyu_visuals("val", torch.from_numpy(image), tdepth,
                         {k: torch.from_numpy(v) for k, v in outputs.items()},
                         None, 4, log_histogram=False)
    ref.log_nyu_visuals("val", image, depth_n, outputs, None, 4,
                        log_histogram=False)
    assert_same_records(ours.writers["val"].calls, ref.writers["val"].calls)
    assert not tag_set(ours.writers["val"].calls, ("histogram",))


def _checkpoint_tensors(folder):
    out = {}
    for f in sorted(os.listdir(folder)):
        sd = torch.load(os.path.join(folder, f), weights_only=True)
        flat = (dict(sd["state"]) if "state" in sd else {"": sd})
        for key, d in flat.items():
            for k, v in d.items():
                out[(f, key, k)] = v
    return out


def _same_checkpoints(a, b):
    ta, tb = _checkpoint_tensors(a), _checkpoint_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        if torch.is_tensor(ta[k]):
            assert torch.equal(ta[k], tb[k]), k
        else:
            assert ta[k] == tb[k], k


def test_train_kitti_visuals_leave_training_unchanged(tmp_path):
    root = str(tmp_path / "kitti")
    write_mount(root, 4, 75, 124)
    runs = {}
    for name, writers in (("with", {"train": Recorder(), "val": Recorder()}),
                          ("without", {})):
        logger = SummaryLogger("unused", writers=writers)
        summary = train_kitti.main(
            ["--data_path", root, "--split", "tiny", "--log_dir",
             str(tmp_path / name), "--height", "64", "--width", "96",
             "--batch_size", "2", "--use_stereo", "--frame_ids", "0",
             "--use_depth_hints", "--use_wavelets", "--weights_init",
             "scratch", "--num_epochs", "1", "--log_frequency", "1",
             "--num_workers", "1", "--stereo_warp_kernel", "on",
             "--device", "cpu"], logger=logger)
        runs[name] = (summary, writers)
    (with_s, rec), (without_s, _) = runs["with"], runs["without"]
    assert with_s["steps"] == 2 and with_s["val_batches"] == 2
    assert with_s["losses"] == without_s["losses"]
    _same_checkpoints(with_s["checkpoints"][-1], without_s["checkpoints"][-1])
    for mode in ("train", "val"):
        calls = rec[mode].calls
        assert KITTI_TAGS <= tag_set(calls)
        assert tag_set(calls, ("image", "histogram")) == {
            t for t in KITTI_TAGS if not t.startswith(("min/", "max/"))}
        assert {c[3] for c in calls} == {0, 1}


@pytest.fixture(scope="module")
def nyu_zip(tmp_path_factory):
    path = tmp_path_factory.mktemp("nyu_vis") / "nyu_data.zip"
    rng = np.random.RandomState(3)
    rows = []
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(4):
            for name, arr in (
                    (f"data/img_{i}.png",
                     rng.randint(0, 255, (480, 640, 3), dtype=np.uint8)),
                    (f"data/dep_{i}.png",
                     (rng.rand(480, 640) * 255).astype(np.uint8))):
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "PNG")
                zf.writestr(name, buf.getvalue())
            rows.append(f"data/img_{i}.png,data/dep_{i}.png")
        zf.writestr("data/nyu2_train.csv", "\n".join(rows))
    return str(path)


def test_train_nyu_visuals_leave_training_unchanged(nyu_zip, tmp_path):
    runs = {}
    for name, writers in (("with", {"train": Recorder(), "val": Recorder()}),
                          ("without", {})):
        summary = train_nyu.main(
            ["--data_path", nyu_zip, "--log_dir", str(tmp_path / name),
             "--model_name", "mini", "--epochs", "1", "--log_frequency",
             "1", "--encoder_type", "mobilenet_light", "--use_wavelets",
             "--use_224", "--batch_size", "2", "--num_workers", "2",
             "--device", "cpu", "--no-pretrained_encoder"],
            logger=SummaryLogger("unused", writers=writers))
        runs[name] = (summary, writers)
    (with_s, rec), (without_s, _) = runs["with"], runs["without"]
    assert with_s["steps"] == 2 and with_s["val_batches"] == 2
    assert with_s["losses"] == without_s["losses"]
    assert with_s["val_losses"] == without_s["val_losses"]
    _same_checkpoints(with_s["checkpoints"][-1], without_s["checkpoints"][-1])
    for mode in ("train", "val"):           # --use_224's decoder
        assert tag_set(rec[mode].calls, ("image", "histogram")) == \
            NYU_224_TAGS
