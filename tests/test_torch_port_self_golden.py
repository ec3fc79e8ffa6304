"""The port's self-golden check (tools/self_golden.py) against the JAX
package's harness (tools_dev/self_golden_experiment.py), at 64x96 on a
JAX-fabricated eigen mount of 3 test frames and a seeded reference-layout
checkpoint (test_torch_port_eval.py's fixtures), on the CPU:

  * legs A and B: the tool's dense row and sparse ladder equal the rows of
    JAX's `tools/evaluate_depth.main` on the same mount, weights and flags
    (rows within 1e-4, test_evaluate_depth_main_equals_jax's tolerance;
    densities within 1e-6);
  * the decisions (operating point, relative abs_rel gap, the five checks
    and "ok") equal those of JAX's own script run on the same fixed rows,
    its evaluation and oracle replaced, in five cases;
  * leg C: the checkpoint crossed into JAX (`tools/torch_import.py`) and
    forwarded on the first test frame gives the port's disparities within
    1e-4 per scale in float32: the stand-in for the reference decoder
    that JAX's leg C forwards;
  * the entry points: the newest weights_N of a log dir, --device cuda
    raising without a card, --out the only file written, and the
    checkpoint checked loaded whatever WMD_TORCH_MODEL_PATH says.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_eval import mount, weights  # noqa: F401
from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.tools import evaluate_depth as jed
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ted
from wavelet_monodepth_tpu_torch.tools import self_golden as sg
from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
THRESHOLDS = sg.THRESHOLDS
SIZE = ["--height", str(H), "--width", str(W), "--batch_size", "3"]


def _args(mount, folder):
    return sg.parse_args(["--data_path", mount, "--load_weights_folder",
                          folder, "--out", "unused.json"] + SIZE)


def _jax_result():
    with open(os.path.join(REPO, "artifacts", "self_golden_r5.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory, weights):  # noqa: F811
    """A trainer's log dir: models/weights_0..3, the newest holding the
    seeded checkpoint and the older ones empty."""
    root = str(tmp_path_factory.mktemp("logs"))
    models = os.path.join(root, "soak", "models")
    for n in range(3):
        os.makedirs(os.path.join(models, f"weights_{n}"))
    os.symlink(weights, os.path.join(models, "weights_3"))
    return root


@pytest.fixture(scope="module")
def tool_run(mount, log_dir, tmp_path_factory):  # noqa: F811
    """The tool on the CPU: (its summary, the files it wrote)."""
    out_dir = tmp_path_factory.mktemp("out")
    before = {os.path.join(d, f) for top in (mount, log_dir, str(out_dir))
              for d, _, fs in os.walk(top, followlinks=True) for f in fs}
    out = os.path.join(out_dir, "self_golden.json")
    summary = sg.main(["--data_path", mount, "--log_dir", log_dir,
                       "--out", out, "--device", "cpu"] + SIZE)
    after = {os.path.join(d, f) for top in (mount, log_dir, str(out_dir))
             for d, _, fs in os.walk(top, followlinks=True) for f in fs}
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    return summary, sorted(after - before)


@pytest.fixture(scope="module")
def jax_rows(mount, weights):  # noqa: F811
    """JAX's evaluate_depth.main rows with the harness's flags: {"dense":
    row, threshold: row}."""
    # the tool's flags without its last two, "--device cpu", which JAX's
    # parser lacks; JAX reads a reference folder from the environment
    base = sg.eval_argv(_args(mount, weights), weights, "cpu")[:-2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WMD_TORCH_MODEL_PATH", weights)
        rows = {"dense": jed.main(base)}
        for th in THRESHOLDS:
            rows[th] = jed.main(base + ["--use_sparse", "--threshold",
                                        str(th)])
    return rows


# --- legs A and B -----------------------------------------------------------

@pytest.mark.parametrize("row", ["dense"] + list(THRESHOLDS))
def test_rows_equal_jax(tool_run, jax_rows, row):
    summary, _ = tool_run
    ref = jax_rows[row]
    if row == "dense":
        ours = summary["dense"]
        assert ref["density_mean"] is None
    else:
        (r,) = [r for r in summary["sparse_rows"] if r["threshold"] == row]
        ours = r["metrics"]
        assert 0 < r["density"] <= 1
        np.testing.assert_allclose(r["density"], ref["density_mean"],
                                   rtol=0, atol=1e-6)
    assert list(ours) == list(ref["metrics"])
    np.testing.assert_allclose(list(ours.values()),
                               list(ref["metrics"].values()), rtol=0,
                               atol=1e-4)


def test_summary_keys_equal_jax(tool_run):
    """JAX's keys (its round-5 result file), the checks computed from the
    tool's own rows, and the operating point the ladder's nearest."""
    summary, _ = tool_run
    ref = _jax_result()
    assert set(ref) <= set(summary)
    assert list(summary["checks"]) == list(ref["checks"])
    assert [r["threshold"] for r in summary["sparse_rows"]] == list(
        THRESHOLDS)
    assert summary["checkpoint"].endswith(os.path.join("soak", "models",
                                                       "weights_3"))
    got = sg.decide({"metrics": summary["dense"]}, summary["sparse_rows"],
                    summary["torch_oracle"], 0.10)
    assert got == {k: summary[k] for k in got}
    assert summary["ok"] == all(summary["checks"].values())


# --- the decisions against JAX's own script ----------------------------------

def _metrics(abs_rel, rmse=4.0):
    return {"abs_rel": abs_rel, "sq_rel": 0.8, "rmse": rmse,
            "rmse_log": 0.2, "a1": 0.85, "a2": 0.95, "a3": 0.98}


def _case(name):
    """(dense metrics, {threshold: (density, metrics)}, oracle)."""
    close = {f"disp{s}_maxerr": 5e-4 for s in range(4)}
    close["pred_disp0_mean"] = 0.06
    if name == "r5":            # JAX's own recorded run
        r5 = _jax_result()
        return (r5["dense"], {r["threshold"]: (r["density"], r["metrics"])
                              for r in r5["sparse_rows"]},
                r5["torch_oracle"])
    ladders = {
        "pass": ((0.30, 0.1003), (0.12, 0.1010), (0.05, 0.1030)),
        "far_density": ((0.60, 0.1001), (0.45, 0.1002), (0.30, 0.1004)),
        "big_delta": ((0.30, 0.1003), (0.11, 0.1030), (0.05, 0.1040)),
        "non_finite": ((0.30, 0.1003), (0.12, 0.1010), (0.05, 0.1030)),
    }
    dense = _metrics(0.1, rmse=float("nan") if name == "non_finite"
                     else 4.0)
    return (dense, {th: (d, _metrics(a)) for th, (d, a)
                    in zip(THRESHOLDS, ladders[name])}, close)


def _fake_eval(dense, rows):
    def ev_main(argv):
        if "--use_sparse" in argv:
            density, metrics = rows[float(argv[argv.index("--threshold")
                                               + 1])]
            return {"metrics": metrics, "density_mean": density}
        return {"metrics": dense, "density_mean": None}
    return ev_main


def _load_jax_script(monkeypatch):
    # the script puts the repo root on sys.path when it is loaded
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "self_golden_experiment",
        os.path.join(REPO, "tools_dev", "self_golden_experiment.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["pass", "far_density", "big_delta",
                                  "non_finite", "r5"])
def test_decisions_equal_jax_script(case, tmp_path, monkeypatch):
    dense, rows, oracle = _case(case)
    mod = _load_jax_script(monkeypatch)
    os.makedirs(tmp_path / "artifacts")
    monkeypatch.setattr(mod, "REPO", str(tmp_path))
    monkeypatch.setattr(mod, "newest_checkpoint", lambda: "ckpt")
    monkeypatch.setattr(mod, "torch_oracle", lambda ckpt: oracle)
    monkeypatch.setattr(jed, "main", _fake_eval(dense, rows))
    mod.main()
    with open(tmp_path / "artifacts" / "self_golden_r5.json") as f:
        ref = json.load(f)

    monkeypatch.setattr(ted, "main", _fake_eval(dense, rows))
    monkeypatch.setattr(sg, "torch_oracle", lambda opts, device: oracle)
    ours = sg.main(["--data_path", str(tmp_path), "--load_weights_folder",
                    "ckpt", "--out", str(tmp_path / "ours.json"),
                    "--device", "cpu"])
    assert ours["operating_point"] == ref["operating_point"]
    assert ours["sparse_vs_dense_absrel_rel_delta"] == ref[
        "sparse_vs_dense_absrel_rel_delta"]
    assert ours["checks"] == ref["checks"]
    assert ours["ok"] == ref["ok"]
    assert ours["sparse_rows"] == ref["sparse_rows"]
    if case == "pass":
        assert ours["ok"]
    else:
        assert not ours["ok"]


# --- leg C ------------------------------------------------------------------

def test_leg_c_equals_jax(mount, weights, tool_run):  # noqa: F811
    """The port's oracle forward (the checkpoint as the eval loads it, the
    first test frame as the eval feeds it) against JAX's forward of the
    same weights crossed by JAX's own importers: every scale within 1e-4;
    the tool's CPU oracle reports 0 gaps and this forward's mean."""
    opts = parse_kitti_args(sg.eval_argv(_args(mount, weights), weights,
                                         "cpu"))
    image = sg.first_test_frame(opts)
    assert image.shape == (1, H, W, 3) and image.dtype == np.uint8
    ours = sg.oracle_disps(opts, "cpu", image)

    enc, dec = JEncoder(num_layers=18), JDecoder(num_ch_enc=j_num_ch_enc(18))
    ev = jti.import_resnet_encoder(
        jti.load_pth(os.path.join(weights, "encoder.pth")), 18)
    dv = jti.import_kitti_wavelet_decoder(
        jti.load_pth(os.path.join(weights, "depth.pth")))
    x = jnp.asarray(image.astype(np.float32) / 255.0)
    with jax.default_matmul_precision("highest"):
        ref = dec.apply(dv, enc.apply(ev, x))
    for s in range(4):
        got = np.asarray(ref[("disp", s)], np.float32)
        assert ours[s].shape == got.shape == (1, H >> s, W >> s, 1)
        assert np.max(np.abs(ours[s] - got)) <= 1e-4, s

    oracle = tool_run[0]["torch_oracle"]
    assert [oracle[f"disp{s}_maxerr"] for s in range(4)] == [0.0] * 4
    np.testing.assert_allclose(oracle["pred_disp0_mean"],
                               float(np.mean(ours[0])), rtol=0, atol=1e-6)


# --- entry points -------------------------------------------------------------

def test_newest_checkpoint(tmp_path):
    models = tmp_path / "run" / "models"
    for n in range(4):
        os.makedirs(models / f"weights_{n}")
    (models / "opt.json").write_text("{}")
    assert sg.newest_checkpoint(str(tmp_path), "run") == str(
        models / "weights_3")
    os.makedirs(models / "weights_12")          # by number, not by name
    assert sg.newest_checkpoint(str(tmp_path), "run") == str(
        models / "weights_12")
    with pytest.raises(FileNotFoundError, match="weights_N"):
        sg.newest_checkpoint(str(tmp_path), "other")
    with pytest.raises(SystemExit):             # one of the two sources
        sg.parse_args(["--data_path", "x", "--out", "y"])


def test_checkpoint_wins_over_environment(tmp_path, monkeypatch):
    """With WMD_TORCH_MODEL_PATH naming another folder, every eval and
    leg C still load the checkpoint the summary names."""
    monkeypatch.setenv("WMD_TORCH_MODEL_PATH", str(tmp_path / "other"))
    dense, rows, oracle = _case("pass")
    fake, loaded = _fake_eval(dense, rows), []

    def ev_main(argv):
        loaded.append(ted.parse_args(argv)[1])
        return fake(argv)

    def leg_c(opts, device):
        loaded.append(opts.load_weights_folder)
        return oracle

    monkeypatch.setattr(ted, "main", ev_main)
    monkeypatch.setattr(sg, "torch_oracle", leg_c)
    s = sg.main(["--data_path", str(tmp_path), "--load_weights_folder",
                 "ckpt", "--out", str(tmp_path / "s.json"), "--device",
                 "cpu"])
    assert s["checkpoint"] == "ckpt"
    assert loaded == ["ckpt"] * (2 + len(THRESHOLDS))


def test_writes_only_out(tool_run):
    _, written = tool_run
    assert [os.path.basename(p) for p in written] == ["self_golden.json"]


def test_device_cuda_raises_without_card(mount, log_dir, tmp_path,  # noqa: F811
                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "x.json")
    argv = ["--data_path", mount, "--log_dir", log_dir, "--out", out] + SIZE
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sg.main(argv)                           # --device cuda by default
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sg.main(argv + ["--device", "cuda"])
    assert not os.path.exists(out)
