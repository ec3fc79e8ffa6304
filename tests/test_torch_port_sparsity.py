"""Port parity, the sparsity-curve tools: wavelet_monodepth_tpu_torch's
tools/sparsity_sweep.py, plot_sparsity_curve.py and profile_model.py
against the JAX package's, at 64x96, B=2, ResNet18, on weights crossed
through a reference folder (tools/torch_import.py).

Tolerances, each with its reason: densities 1e-3 absolute (a
coefficient within float32 reassociation of its threshold may flip;
none did at this size), GFLOPs 1e-6 relative (the op counters are exact
integers summed in float32), disp_mae_vs_dense 1e-5 and abs_rel_vs_gt
1e-4 (the disparities differ by float32 reassociation between XLA and
ATen, tests/test_torch_port_eval.py), the synthetic loop's losses 1e-4
relative after 3 Adam steps. Latency is not compared: JAX's slope timer
is replaced by a constant here (its K-fold loop would only add compiles).
"""

import argparse
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.ops.sparse import compute_density as j_density
from wavelet_monodepth_tpu.tools import profile_model as jpm
from wavelet_monodepth_tpu.tools import sparsity_sweep as jss
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.utils import maskgen as jmg
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.layers import init_params
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.tools import plot_sparsity_curve as tplot
from wavelet_monodepth_tpu_torch.tools import profile_model as tpm
from wavelet_monodepth_tpu_torch.tools import sparsity_sweep as tss
from wavelet_monodepth_tpu_torch.tools import torch_import as ti

torch.set_num_threads(1)
H, W, B = 64, 96, 2
SHAPE = ["--height", str(H), "--width", str(W), "--batch", str(B)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference folder of seeded port weights with non-trivial BN
    statistics."""
    folder = str(tmp_path_factory.mktemp("weights"))
    g = torch.Generator().manual_seed(7)
    enc = init_params(ResnetEncoder(18), g)
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), g)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(1 + 0.2 * torch.rand(c, generator=g))
    ti.save_reference_checkpoint(folder, enc, dec, H, W)
    return folder


def _jax_vars(folder):
    ev = jti.import_resnet_encoder(
        jti.load_pth(os.path.join(folder, "encoder.pth")), 18)
    dv = jti.import_kitti_wavelet_decoder(
        jti.load_pth(os.path.join(folder, "depth.pth")))
    return (jax.tree_util.tree_map(jnp.asarray, ev),
            jax.tree_util.tree_map(jnp.asarray, dv))


def _port_models(folder):
    enc = ResnetEncoder(18)
    dec = KittiWaveletDecoder(enc.num_ch_enc)
    ti.load_state_dicts(enc, dec, *ti.load_reference_checkpoint(folder))
    return enc.eval(), dec.eval()


def _row_key(r):
    return (r["mask_family"], r.get("target_density", r["threshold"]))


@pytest.fixture(scope="module")
def sweeps(weights, tmp_path_factory):
    """Both sweeps on the folder's weights (JAX's slope timer stubbed) and
    the port's JSON."""
    out = str(tmp_path_factory.mktemp("sweep") / "port.json")
    argv = SHAPE + ["--weights", "torch", "--torch_model_path", weights,
                    "--thresholds", "-1", "0.02", "0.1", "0.3",
                    "--densities", "0.1", "0.2"]
    slope = jss._slope
    jss._slope = lambda fn, k0, k1: 1e-3
    try:
        ref = jss.main(argv + ["--k", "1", "2"])
    finally:
        jss._slope = slope
    ours = tss.main(argv + ["--k", "1", "2", "--device", "cpu", "--out",
                            out])
    return ref, ours, out


def test_sweep_rows_match_jax(sweeps):
    ref, ours, _ = sweeps
    assert [_row_key(r) for r in ours["rows"]] == \
        [_row_key(r) for r in ref["rows"]]
    for a, b in zip(ours["rows"], ref["rows"]):
        assert set(b) - {"latency_unreliable"} <= set(a), _row_key(b)
        assert a["weights"] == b["weights"] == "torch"
        assert abs(a["density"] - b["density"]) <= 1e-3, _row_key(b)
        assert a["gflops"] == pytest.approx(b["gflops"], rel=1e-6)
        assert abs(a["disp_mae_vs_dense"] - b["disp_mae_vs_dense"]) <= 1e-5
        assert abs(a["abs_rel_vs_gt"] - b["abs_rel_vs_gt"]) <= 1e-4
        if a["mask_family"] == "edge":
            assert a["threshold"] == b["threshold"]
            assert a["density"] == b["density"]
        assert a["ms_per_image"] is None or a["ms_per_image"] > 0
    dense, minus1 = ours["rows"][:2]
    assert dense["density"] == minus1["density"] == 1.0
    assert dense["gflops"] == minus1["gflops"]
    assert minus1["disp_mae_vs_dense"] == 0.0
    th = [r["density"] for r in ours["rows"] if r["mask_family"]
          == "threshold"]
    assert th == sorted(th, reverse=True) and th[-1] < 1.0
    assert set(ref["meta"]) <= set(ours["meta"])
    assert ours["meta"]["measurement"].startswith("host clock")
    assert ours["meta"]["shape"] == ref["meta"]["shape"]


def test_plot_reads_both_packages_json(sweeps, tmp_path):
    _, _, port_json = sweeps
    committed = sorted(glob.glob(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "artifacts", "sparsity_curve_r4_*.json")))
    assert len(committed) == 2
    png = tplot.main(committed[:1] + [port_json, "--out",
                                      str(tmp_path / "curve.png")])
    assert os.path.getsize(png) > 10_000
    png = tplot.main([committed[1], "--out", str(tmp_path / "nyu.png")])
    assert os.path.getsize(png) > 10_000


def test_synthetic_loop_matches_jax_optax(weights):
    """The `synthetic` source's loop against JAX's optax loop rebuilt from
    `sparsity_sweep.py:170-200` for 3 steps on the same weights: the
    per-step L1 losses within 1e-4 relative. JAX differentiates its whole
    variable tree, BN statistics included, and so does the port."""
    ev, dv = _jax_vars(weights)
    encoder, decoder = JEncoder(num_layers=18), JDecoder(
        num_ch_enc=j_num_ch_enc(18))
    tx = optax.adam(1e-4)
    params = {"enc": ev, "dec": dv}
    opt_state = tx.init(params)
    train_disp = jmg.synthetic_depth_scene(B, H, W, seed=100)
    xs = jnp.asarray(jmg.scene_image(train_disp, seed=100))
    ys = jnp.asarray(train_disp)

    def loss_fn(ps, img, disp):
        out = decoder.apply(ps["dec"], encoder.apply(ps["enc"], img))
        return jnp.abs(out[("disp", 0)] - disp).mean()

    @jax.jit
    def step(ps, os_, img, disp):
        loss, grads = jax.value_and_grad(loss_fn)(ps, img, disp)
        updates, os_ = tx.update(grads, os_, ps)
        return optax.apply_updates(ps, updates), os_, loss

    ref = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, xs, ys)
        ref.append(float(loss))

    enc, dec = _port_models(weights)
    args = argparse.Namespace(batch=B, height=H, width=W)
    ours = tss.synthetic_train(enc, dec, args, (H, W), "cpu", 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    assert ours[-1] < ours[0]
    # the statistics moved, and the modules are back to plain BN
    assert not enc.encoder.bn1.running_var.requires_grad
    assert "forward" not in vars(enc.encoder.bn1)
    fresh, _ = _port_models(weights)
    assert not torch.equal(enc.encoder.bn1.running_mean,
                           fresh.encoder.bn1.running_mean)


def test_nyu_sweep_runs(tmp_path):
    """--dataset nyu sweeps DecoderWave: no edge-mask family, the GT fitted
    to the half-resolution output, thresh -1 equal to dense."""
    res = tss.main(["--dataset", "nyu", "--encoder_type", "mobilenet_light",
                    "--height", str(H), "--width", str(W), "--batch", "1",
                    "--thresholds", "-1", "0.1", "--train_steps", "1",
                    "--k", "1", "1", "--weights", "random", "synthetic",
                    "--device", "cpu", "--out", str(tmp_path / "nyu.json")])
    rows = res["rows"]
    assert [r["mask_family"] for r in rows] == ["dense", "threshold",
                                                "threshold"] * 2
    for r in rows:
        assert np.isfinite(r["abs_rel_vs_gt"]) and r["gflops"] > 0
    t = [r for r in rows if r["threshold"] == -1][0]
    assert t["disp_mae_vs_dense"] == 0.0 and t["density"] == 1.0
    assert res["meta"]["model"] == "mobilenet_light + NYU DecoderWave"
    assert res["meta"]["train_steps"] == 1
    with open(tmp_path / "nyu.json") as f:
        assert json.load(f)["rows"] == json.loads(json.dumps(rows))


def test_profile_model_analytic_sweep_matches_jax(weights, tmp_path):
    """The analytic total_ops / density sweep on the folder's weights
    against JAX's (`profile_model.py:64-73`, rebuilt: JAX's own main
    stops there with a NameError, ROADMAP.md Queue 3), and the port's CLI
    on the CPU: its FLOP counter, sweep and Chrome trace."""
    x = np.random.RandomState(0).rand(1, H, W, 3).astype(np.float32)
    ev, dv = _jax_vars(weights)
    encoder, decoder = JEncoder(num_layers=18), JDecoder(
        num_ch_enc=j_num_ch_enc(18))
    thresholds = [-1, 0.05, 0.1, 0.3]
    ref = []
    for th in thresholds:
        out = decoder.apply(dv, encoder.apply(ev, jnp.asarray(x)),
                            thresh_ratio=float(th))
        ref.append((float(np.mean(out[("total_ops", -1)])) / 1e9,
                    float(j_density(out))))
    enc, dec = _port_models(weights)
    ours = tpm.analytic_sweep(enc, dec, torch.from_numpy(x), thresholds)
    assert [r["threshold"] for r in ours] == thresholds
    for r, (gf, dens) in zip(ours, ref):
        assert r["decoder_gflops"] == pytest.approx(gf, rel=1e-6)
        assert abs(r["density"] - dens) <= 1e-6
    assert ours[0]["density"] == 1.0 and ours[-1]["density"] < 1.0

    with pytest.raises(NameError, match="np"):
        jpm.main(["--height", str(H), "--width", str(W)])

    report = tpm.main(["--height", str(H), "--width", str(W), "--device",
                       "cpu", "--trace_dir", str(tmp_path / "trace")])
    assert set(report) == {"torch_flop_counter", "analytic_sweep", "trace"}
    counter = report["torch_flop_counter"]
    assert counter["flops"] > 0
    assert counter["flops"] == sum(counter["by_op"].values())
    assert [r["threshold"] for r in report["analytic_sweep"]] == [-1, 0.05,
                                                                  0.1]
    with open(report["trace"]) as f:
        assert json.load(f)["traceEvents"]
    assert report["analytic_sweep"][0]["density"] == 1.0


@pytest.mark.parametrize("tool", [tss, tpm])
def test_tools_need_a_card_unless_cpu(tool, monkeypatch):
    """Both tools run on the card by default and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main([])
