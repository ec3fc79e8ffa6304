"""Port parity, the release-gate pre-flight: the port's golden_check and
fetch_pretrained against the JAX package's, on the mini-mounts of
tests/test_golden_check.py (its fixtures, fabricated once here).

Both packages' run_checks see the same environment mapping per scenario:
every mount's status ([ OK ] / [ -- ] / [FAIL]), the number of failing
mounts and the exit codes (with and without --require_all) must be
equal, and each broken mount's details must name the same file or key
in both. fetch_pretrained: the same report on the reference-layout
folders, except a ResNet50 folder, which the port reads as resnet50 and
JAX as resnet18 (ROADMAP queue 3).
"""

import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from test_golden_check import (DRIVE, _save_pth, kitti_weights,  # noqa: F401
                               mini_kitti, nyu_mat, nyu_weights, odom_tree,
                               pose_weights)
from test_torch_import import _resnet18_sd, _wavelet_decoder_sd

from wavelet_monodepth_tpu.tools import fetch_pretrained as jfp
from wavelet_monodepth_tpu.tools import golden_check as jgc
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.layers import init_params
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.tools import fetch_pretrained as tfp
from wavelet_monodepth_tpu_torch.tools import golden_check as tgc
from wavelet_monodepth_tpu_torch.tools import torch_import as ti

_LINE = re.compile(r"^(\[ OK \]|\[ -- \]|\[FAIL\]) (WMD_\w+)")


def _statuses(text: str) -> dict:
    """{var: (status, its detail text)} from run_checks' output."""
    out, var = {}, None
    for line in text.splitlines():
        m = _LINE.match(line)
        if m:
            var = m.group(2)
            out[var] = [m.group(1), ""]
        elif line.startswith("       - ") and var is not None:
            out[var][1] += line
    return {k: tuple(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def broken(tmp_path_factory, mini_kitti, kitti_weights,  # noqa: F811
           odom_tree, pose_weights, nyu_mat, nyu_weights):
    """Broken copies of the mini-mounts, one fault each."""
    root = tmp_path_factory.mktemp("broken")
    out = {}
    d = root / "kitti_no_gt"
    shutil.copytree(mini_kitti, d)
    os.remove(d / "splits" / "eigen" / "gt_depths.npz")
    out["kitti_no_gt"] = str(d)
    d = root / "kitti_no_image"
    shutil.copytree(mini_kitti, d)
    os.remove(d / DRIVE / "image_02" / "data" / "0000000002.jpg")
    out["kitti_no_image"] = str(d)
    d = root / "weights_no_depth"
    d.mkdir()
    _save_pth(d / "encoder.pth", _resnet18_sd())
    out["weights_no_depth"] = str(d)
    d = root / "weights_missing_key"
    d.mkdir()
    sd = _resnet18_sd()
    del sd["encoder.layer4.1.conv2.weight"]
    _save_pth(d / "encoder.pth", sd)
    _save_pth(d / "depth.pth", _wavelet_decoder_sd())
    out["weights_missing_key"] = str(d)
    d = root / "odom_no_poses"
    shutil.copytree(odom_tree, d)
    os.remove(d / "poses" / "10.txt")
    out["odom_no_poses"] = str(d)
    d = root / "pose_single_image"
    d.mkdir()
    _save_pth(d / "pose_encoder.pth",
              {k[len("encoder."):]: v for k, v in _resnet18_sd().items()
               if k.startswith("encoder.")})
    shutil.copy(os.path.join(pose_weights, "pose.pth"), d / "pose.pth")
    out["pose_single_image"] = str(d)
    from scipy.io import savemat
    out["splits_99"] = str(root / "splits.mat")
    savemat(out["splits_99"], {"testNdxs": np.array([[1], [99]])})
    sd = torch.load(nyu_weights, map_location="cpu", weights_only=False)
    del sd["decoder.wave2.conv.weight"]
    out["nyu_no_wave2"] = str(root / "model.pth")
    torch.save(sd, out["nyu_no_wave2"])
    (root / "edges_empty").mkdir()
    out["edges_empty"] = str(root / "edges_empty")
    (root / "edges").mkdir()
    from PIL import Image
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(root / "edges" /
                                                     "0001.png")
    out["edges"] = str(root / "edges")
    return out


# scenario -> {var: (mount key, the token both packages' details name)}
SCENARIOS = {
    "absent": {},
    "kitti": {"WMD_KITTI_DATA": ("mini_kitti", None),
              "WMD_KITTI_WEIGHTS": ("kitti_weights", None),
              "WMD_KITTI_WEIGHTS_R50": ("kitti_weights", "resnet18"),
              "WMD_KITTI_WEIGHTS_R18_1024": ("kitti_weights", "height=192"),
              "WMD_KITTI_WEIGHTS_R50_1024": ("weights_no_depth",
                                             "depth.pth")},
    "kitti_broken": {"WMD_KITTI_DATA": ("kitti_no_gt", "export_gt_depth"),
                     "WMD_KITTI_WEIGHTS": ("weights_missing_key",
                                           "layer4.1.conv2"),
                     "WMD_KITTI_ODOM_DATA": ("odom_no_poses", "10.txt")},
    "pose": {"WMD_KITTI_DATA": ("kitti_no_image", "0000000002"),
             "WMD_KITTI_ODOM_DATA": ("odom_tree", None),
             "WMD_KITTI_POSE_WEIGHTS": ("pose_weights", None)},
    "pose_broken": {"WMD_KITTI_POSE_WEIGHTS": ("pose_single_image",
                                               "input channels"),
                    "WMD_KITTI_ODOM_DATA": ("/nonexistent/odom",
                                            "not a directory")},
    "nyu": {"WMD_NYU_MAT": ("mat", None), "WMD_NYU_SPLITS": ("splits", None),
            "WMD_NYU_WEIGHTS": ("nyu_weights", None),
            "WMD_NYU_EDGES": ("edges", None)},
    "nyu_broken": {"WMD_NYU_MAT": ("mat", None),
                   "WMD_NYU_SPLITS": ("splits_99", "99"),
                   "WMD_NYU_WEIGHTS": ("nyu_no_wave2", "wave2"),
                   "WMD_NYU_EDGES": ("edges_empty", "NNNN.png")},
}


@pytest.fixture(scope="module")
def mounts(mini_kitti, kitti_weights, odom_tree,  # noqa: F811
           pose_weights, nyu_mat, nyu_weights, broken):
    return {"mini_kitti": mini_kitti, "kitti_weights": kitti_weights,
            "odom_tree": odom_tree, "pose_weights": pose_weights,
            "mat": nyu_mat[0], "splits": nyu_mat[1],
            "nyu_weights": nyu_weights, **broken}


def _exit_jax(monkeypatch, env: dict, argv) -> int:
    with monkeypatch.context() as m:
        for var, _, _ in jgc.MOUNTS:
            m.delenv(var, raising=False)
        for k, v in env.items():
            m.setenv(k, v)
        return jgc.main(argv)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_run_checks_status_equals_jax(scenario, mounts, monkeypatch):
    spec = SCENARIOS[scenario]
    env = {var: mounts.get(key, key) for var, (key, _) in spec.items()}
    outs = {}
    for name, gc in (("jax", jgc), ("port", tgc)):
        buf = io.StringIO()
        failures = gc.run_checks(env=env, out=buf)
        outs[name] = (failures, _statuses(buf.getvalue()), buf.getvalue())
    assert outs["port"][0] == outs["jax"][0], (outs["jax"][2],
                                               outs["port"][2])
    jax_st, port_st = outs["jax"][1], outs["port"][1]
    assert set(port_st) == {v for v, _, _ in tgc.MOUNTS} == set(jax_st)
    for var in port_st:
        assert port_st[var][0] == jax_st[var][0], (var, outs["jax"][2],
                                                   outs["port"][2])
    for var, (_, token) in spec.items():
        if token is not None:
            assert jax_st[var][0] == "[FAIL]"
            assert token in jax_st[var][1] and token in port_st[var][1], (
                var, jax_st[var][1], port_st[var][1])
    if scenario in ("absent", "pose"):      # the exit codes, both CLIs
        for argv in ([], ["--require_all"]):
            assert tgc.main(argv, env=env, out=io.StringIO()) == \
                _exit_jax(monkeypatch, env, argv)


def test_absent_mounts_hint_names_the_port_gates():
    buf = io.StringIO()
    assert tgc.main([], env={}, out=buf) == 0
    assert tgc.main(["--require_all"], env={}, out=io.StringIO()) == 1
    assert buf.getvalue().count("[ -- ]") == len(tgc.MOUNTS) == 11
    assert "GOLDEN_GATES.md" in buf.getvalue()


def test_all_ok_hint_names_the_port_gate_file(monkeypatch):
    monkeypatch.setattr(tgc, "MOUNTS", [("WMD_X", "x", lambda v, e: [])])
    buf = io.StringIO()
    assert tgc.main([], env={"WMD_X": "1"}, out=buf) == 0
    assert "tests/test_torch_port_integration_data.py" in buf.getvalue()


def test_nyu_mat_without_h5py_is_a_plain_fail(nyu_mat,  # noqa: F811
                                              monkeypatch):
    """The card's machine has no h5py: the mat mount fails with a line
    that names h5py, and the splits cross-check says so too."""
    monkeypatch.setattr(tgc, "_h5py", lambda: None)
    buf = io.StringIO()
    env = {"WMD_NYU_MAT": nyu_mat[0], "WMD_NYU_SPLITS": nyu_mat[1]}
    assert tgc.run_checks(env=env, out=buf) == 2
    st = _statuses(buf.getvalue())
    for var in env:
        assert st[var][0] == "[FAIL]" and "h5py" in st[var][1]
        assert "validator error" not in st[var][1]


@pytest.mark.parametrize("depth,prefix", [(18, "encoder."), (34, "encoder."),
                                          (50, "encoder."), (101, ""),
                                          (152, "")])
def test_resnet_layers_of_equals_jax(depth, prefix):
    enc = ResnetEncoder(num_layers=depth)
    sd = {k if prefix else k[len("encoder."):]: v
          for k, v in enc.state_dict().items()}
    assert tgc.resnet_layers_of(sd, prefix) == depth == \
        jgc._resnet_layers_of(sd, prefix)


@pytest.fixture(scope="module")
def r50_folder(tmp_path_factory):
    """A seeded ResNet50 + wavelet decoder folder in the reference layout."""
    folder = str(tmp_path_factory.mktemp("r50"))
    gen = torch.Generator().manual_seed(3)
    enc = init_params(ResnetEncoder(50), gen)
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), gen)
    ti.save_reference_checkpoint(folder, enc, dec, 320, 1024)
    return folder


def test_fetch_pretrained_names_resnet50(r50_folder):
    port, jax_report = tfp.check_folder(r50_folder), \
        jfp.check_folder(r50_folder)
    assert port["ok"] and port["kind"] == "kitti"
    assert "imported as resnet50 + wavelet decoder" in port["details"]
    assert "{'height': 320, 'width': 1024, 'use_stereo': 1}" in \
        port["details"][0]
    # JAX's depth test calls every bottleneck ResNet a resnet18
    assert "imported as resnet18 + wavelet decoder" in jax_report["details"]


def test_fetch_pretrained_kitti_r18(kitti_weights):  # noqa: F811
    port, jax_report = tfp.check_folder(kitti_weights), \
        jfp.check_folder(kitti_weights)
    assert port["ok"] and jax_report["ok"]
    assert port["kind"] == jax_report["kind"] == "kitti"
    assert port["details"][1:] == jax_report["details"][1:] == \
        ["imported as resnet18 + wavelet decoder"]
    assert port["details"][0] == jax_report["details"][0]


def test_fetch_pretrained_nyu(nyu_weights, tmp_path):  # noqa: F811
    shutil.copy(nyu_weights, tmp_path / "model.pth")
    port, jax_report = tfp.check_folder(str(tmp_path)), \
        jfp.check_folder(str(tmp_path))
    assert port == {**jax_report, "path": str(tmp_path)}
    assert port["ok"] and port["kind"] == "nyu"


def test_fetch_pretrained_broken_and_empty(broken, tmp_path):
    for folder in (broken["weights_missing_key"], str(tmp_path)):
        port, jax_report = tfp.check_folder(folder), \
            jfp.check_folder(folder)
        assert not port["ok"] and not jax_report["ok"]
        assert port["kind"] == jax_report["kind"]
    assert "layer4.1.conv2" in port_details(broken["weights_missing_key"])


def port_details(folder: str) -> str:
    return " ".join(tfp.check_folder(folder)["details"])


def test_fetch_pretrained_cli(kitti_weights, capsys):  # noqa: F811
    tfp.main(["--list"])
    assert "kitti_resnet50_1024x320" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        tfp.main(["--check", kitti_weights])
    assert e.value.code == 0
