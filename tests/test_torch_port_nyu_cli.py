"""The port's NYUv2 training CLI end to end on the CPU, its checkpoint,
and the float32 rule of every CLI.

tools/train_nyu.main trains mobilenet_light + NyuDecoderWave224 at batch
2 on a 4-frame zip (the JAX package's own end-to-end test's sizes), writes
the port's NYU checkpoint (model.pth in the reference layout, adam.pth,
models/opt.json), resumes from the newest complete folder, and
tools/evaluate_nyu.main scores the checkpoint on a labeled .mat with
--load_weights_folder, adopting normalize_input from the run's opt.json.
The float32 rule: `utils/device.pin_float32` turns TF32 off for a CUDA
device, and each of the six CLIs' `main` calls it.
"""

import io
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from wavelet_monodepth_tpu_torch.tools import evaluate_nyu, train_nyu
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.train.nyu import NyuTrainSetup
from wavelet_monodepth_tpu_torch.utils import checkpoint as ckpt
from wavelet_monodepth_tpu_torch.utils import device as device_rule
from wavelet_monodepth_tpu_torch.utils.config import NyuOptions

torch.set_num_threads(1)
TRAIN = ["--encoder_type", "mobilenet_light", "--use_wavelets", "--use_224",
         "--batch_size", "2", "--num_workers", "2", "--device", "cpu",
         "--no-pretrained_encoder"]


@pytest.fixture(scope="module")
def nyu_zip(tmp_path_factory):
    path = tmp_path_factory.mktemp("nyu_cli") / "nyu_data.zip"
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


@pytest.fixture(scope="module")
def trained(nyu_zip, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("nyu_logs"))
    summary = train_nyu.main(["--data_path", nyu_zip, "--log_dir", log_dir,
                              "--model_name", "mini", "--epochs", "1",
                              "--log_frequency", "1", "--normalize_input"]
                             + TRAIN)
    return log_dir, summary


def test_train_writes_the_nyu_checkpoint(trained):
    log_dir, summary = trained
    assert summary["steps"] == 2 and summary["val_batches"] == 2
    for losses in summary["losses"] + summary["val_losses"]:
        assert np.isfinite(list(losses.values())).all()
        assert "loss_LL3" in losses           # the 224 decoder's LL term
    folder = os.path.join(log_dir, "mini", "models", "weights_0")
    assert summary["checkpoints"] == [folder]
    assert sorted(os.listdir(folder)) == ["adam.pth", "model.pth"]
    assert os.path.isfile(os.path.join(log_dir, "mini", "models",
                                       "opt.json"))
    sd = torch.load(os.path.join(folder, "model.pth"), weights_only=True)
    assert {k.split(".")[0] for k in sd} == {"encoder", "decoder"}
    assert {str(v.dtype) for v in sd.values() if v.is_floating_point()} \
        == {"torch.float32"}
    # it restores into a fresh state, strict, Adam's moments included
    setup = NyuTrainSetup(NyuOptions(encoder_type="mobilenet_light",
                                     use_wavelets=True, use_224=True,
                                     pretrained_encoder=False, device="cpu"))
    state = setup.init_state(torch.Generator().manual_seed(5))
    ckpt.load_nyu_checkpoint(folder, state)
    restored = ti.nyu_model_state(state.encoder, state.decoder)
    assert set(restored) == set(sd)
    for k, v in sd.items():
        assert torch.equal(restored[k], v), k
    assert len(state.optimizer.state) > 0


@pytest.fixture(scope="module")
def nyu_mat(tmp_path_factory):
    import h5py
    from scipy.io import savemat
    root = tmp_path_factory.mktemp("nyu_mat")
    rng = np.random.RandomState(4)
    data_path = str(root / "nyu_depth_v2_labeled.mat")
    with h5py.File(data_path, "w") as f:
        # mat v7.3 axis order: images (N, 3, W, H), depths (N, W, H)
        f["images"] = rng.randint(0, 255, (3, 3, 640, 480), dtype=np.uint8)
        f["depths"] = (rng.rand(3, 640, 480) * 8 + 1).astype(np.float32)
    splits_path = str(root / "splits.mat")
    savemat(splits_path, {"testNdxs": np.array([[1], [3]]),
                          "trainNdxs": np.array([[2]])})
    return data_path, splits_path


def test_train_then_evaluate_the_checkpoint(trained, nyu_mat, capsys):
    log_dir, _ = trained
    folder = os.path.join(log_dir, "mini", "models", "weights_0")
    data_path, splits_path = nyu_mat
    capsys.readouterr()
    row = evaluate_nyu.main([
        "--data_path", data_path, "--splits_path", splits_path,
        "--load_weights_folder", folder, "--encoder_type",
        "mobilenet_light", "--use_wavelets", "--use_224", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "adopting normalize_input=True" in out
    assert set(row) >= {"abs_rel", "rmse", "log10", "a1", "a2", "a3"}
    assert np.isfinite([row[k] for k in ("abs_rel", "rmse", "log10", "a1",
                                         "a2", "a3")]).all()
    # the scored model is the checkpoint's: its forward equals one built
    # from model.pth by hand
    args = evaluate_nyu.parse_args([
        "--data_path", "-", "--splits_path", "-", "--load_weights_folder",
        folder, "--encoder_type", "mobilenet_light", "--use_wavelets",
        "--use_224", "--device", "cpu"])
    opts = evaluate_nyu.nyu_options(args)
    assert opts.normalize_input is True
    forward = evaluate_nyu.load_forward(opts, torch.device("cpu"))
    setup = NyuTrainSetup(NyuOptions(encoder_type="mobilenet_light",
                                     use_wavelets=True, use_224=True,
                                     pretrained_encoder=False, device="cpu"))
    state = setup.init_state()
    ckpt.load_nyu_checkpoint(folder, state)
    x = torch.rand(1, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    want = setup.eval_step(state, x)
    got = forward(x)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_auto_resume_takes_the_newest_complete_folder(nyu_zip, trained,
                                                      capsys):
    log_dir, _ = trained
    models = os.path.join(log_dir, "mini", "models")
    # a save cut off before adam.pth: skipped for weights_0
    os.makedirs(os.path.join(models, "weights_3"))
    open(os.path.join(models, "weights_3", "model.pth"), "wb").close()
    assert ckpt.latest_checkpoint(os.path.join(log_dir, "mini"),
                                  ckpt.NYU_FILES) == os.path.join(
                                      models, "weights_0")
    assert ckpt.latest_checkpoint(os.path.join(log_dir, "mini")) is None
    capsys.readouterr()
    summary = train_nyu.main(["--data_path", nyu_zip, "--log_dir", log_dir,
                              "--model_name", "mini", "--epochs", "2",
                              "--log_frequency", "999", "--auto_resume"]
                             + TRAIN)
    out = capsys.readouterr().out
    assert "auto-resume: restoring" in out and "weights_0" in out
    assert summary["steps"] == 2
    assert summary["checkpoints"] == [os.path.join(models, "weights_1")]
    assert ckpt.latest_checkpoint(os.path.join(log_dir, "mini"),
                                  ckpt.NYU_FILES) == os.path.join(
                                      models, "weights_1")


def test_pin_float32_turns_tf32_off():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        device_rule.pin_float32(torch.device("cpu"))
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        device_rule.pin_float32(torch.device("cuda"))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class _Pinned(Exception):
    pass


CLIS = {
    "evaluate_depth": ["--data_path", "x", "--eval_stereo", "--device",
                       "cpu"],
    "infer": ["--image_path", "x", "--device", "cpu"],
    "evaluate_nyu": ["--data_path", "x", "--splits_path", "y", "--device",
                     "cpu"],
    "train_kitti": ["--data_path", "x", "--device", "cpu"],
    "bench": ["--device", "cpu"],
    "train_nyu": ["--data_path", "x", "--device", "cpu"],
    "sparsity_sweep": ["--device", "cpu"],
    "profile_model": ["--device", "cpu"],
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_every_cli_pins_float32(monkeypatch, cli):
    """Each CLI's main calls pin_float32 on its device before it does any
    work (the stand-in raises, so nothing past it runs)."""
    import importlib
    seen = []

    def pinned(device):
        seen.append(torch.device(device))
        raise _Pinned
    monkeypatch.setattr(device_rule, "pin_float32", pinned)
    module = importlib.import_module(f"wavelet_monodepth_tpu_torch.tools.{cli}")
    with pytest.raises(_Pinned):
        module.main(CLIS[cli])
    assert seen == [torch.device("cpu")]
