"""Port parity, the measurement tools: tools/bench_grid.py and
tools/profile_device.py of wavelet_monodepth_tpu_torch on the CPU.

  * bench_grid with a 64x96 KITTI R18 config added to CONFIGS (B=1, one
    window): its rows carry the JAX grid's keys (JAX's main run with its
    slope timer stubbed, so nothing is timed there), no `_error`, and a
    density equal to JAX's `compute_density` under the same 10% maskgen
    masks within 1e-6 (with mask_override the density is the masks',
    whatever the weights); a 64x96 NYU DenseNet161 row of the port alone
    (an eager flax init of DenseNet161 takes over a minute);
  * profile_device on the CPU: `attribute` sums CPU self time by module
    path; the rows cover encoder/... and decoder/... and sum to the total
    within 1%; ops outside every module go to UNATTRIBUTED.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.ops.sparse import compute_density as j_density
from wavelet_monodepth_tpu.tools import bench_grid as jbg
from wavelet_monodepth_tpu.utils import maskgen as jmg
from wavelet_monodepth_tpu.utils import timing as jtiming
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.layers import init_params
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.tools import bench_grid as bg
from wavelet_monodepth_tpu_torch.tools import profile_device as pd

torch.set_num_threads(1)
H, W = 64, 96
TINY = "kitti_r18_64x96"


@pytest.fixture
def tiny_configs(monkeypatch):
    cfg = dict(kind="kitti", layers=18, h=H, w=W)
    monkeypatch.setitem(bg.CONFIGS, TINY, cfg)
    monkeypatch.setitem(jbg.CONFIGS, TINY, cfg)
    monkeypatch.setitem(bg.CONFIGS, "nyu_dense161_64x96",
                        dict(kind="nyu", layers=161, h=H, w=W))


def test_bench_grid_row_keys_and_density_equal_jax(tiny_configs,
                                                   monkeypatch, capsys,
                                                   tmp_path):
    out = str(tmp_path / "grid.json")
    rows = bg.main(["--configs", TINY, "--batch", "1", "--windows", "1",
                    "--k1", "1", "--out", out, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"grid": rows}
    with open(out) as f:
        assert json.load(f) == rows
    (row,) = rows
    assert not [k for k in row if k.endswith("_error")], row
    for v in bg.VARIANTS:
        lo, hi = row[v + "_us_minmax"]
        assert row[v + "_us_per_frame"] is not None and 0 < lo <= hi

    # JAX's grid on the same config, its slope timer stubbed
    monkeypatch.setattr(jtiming, "slope_time",
                        lambda fn, k0, k1, reps=2: 1e-3)
    jbg.main(["--configs", TINY, "--batch", "1", "--windows", "1"])
    jrow = json.loads(capsys.readouterr().out.strip().splitlines()[-1]
                      )["grid"][0]
    assert list(row) == list(jrow)
    assert row["config"] == jrow["config"] and row["batch"] == 1
    assert round(row["density"], 4) == jrow["density"]
    assert row["threshold"] == pytest.approx(jrow["threshold"], rel=1e-12)

    # the density under the same masks, unrounded
    disp = jmg.synthetic_depth_scene(1, H, W, seed=0)
    masks, thresh, _ = jmg.masks_at_density(disp, 0.10)
    x = jnp.asarray(jmg.scene_image(disp, seed=0))
    enc = JEncoder(num_layers=18)
    dec = JDecoder(num_ch_enc=j_num_ch_enc(18))
    rng = jax.random.PRNGKey(0)
    ev = enc.init(rng, x)
    dv = dec.init(rng, enc.apply(ev, x))
    jout = dec.apply(dv, enc.apply(ev, x), thresh_ratio=thresh,
                     mask_override={i: jnp.asarray(m)
                                    for i, m in masks.items()})
    assert abs(row["density"] - float(j_density(jout))) <= 1e-6


def test_bench_grid_nyu_row(tiny_configs):
    (row,) = bg.main(["--configs", "nyu_dense161_64x96", "--batch", "1",
                      "--windows", "1", "--k1", "1", "--device", "cpu"])
    assert not [k for k in row if k.endswith("_error")], row
    assert row["threshold"] == 0.05 and 0 < row["density"] <= 1
    assert row["sparse_over_dense_f32"] > 0


def test_bench_grid_records_a_failing_variant(tiny_configs, monkeypatch):
    """A variant that raises gives `<variant>_error` and the others are
    still timed."""
    calls = bg.variant_calls

    def failing(*a):
        out = calls(*a)

        def boom():
            raise RuntimeError("no bf16 here")
        out["sparse_bf16"] = boom
        return out
    monkeypatch.setattr(bg, "variant_calls", failing)
    (row,) = bg.main(["--configs", TINY, "--batch", "1", "--windows", "1",
                      "--k1", "1", "--device", "cpu"])
    assert row["sparse_bf16_error"] == "RuntimeError: no bf16 here"
    assert "sparse_bf16_us_per_frame" not in row
    assert row["dense_bf16_us_per_frame"] > 0


@pytest.mark.parametrize("threshold", [None, 0.2])
def test_profile_device_rows_cover_modules_and_sum(tmp_path, capsys,
                                                   threshold):
    argv = ["--height", str(H), "--width", str(W), "--batch", "1",
            "--iters", "2", "--device", "cpu", "--trace_dir",
            str(tmp_path)]
    if threshold is not None:
        argv += ["--threshold", str(threshold)]
    res = pd.main(argv)
    out = capsys.readouterr().out
    assert out.startswith("total cpu time: ") and res["device"] == "cpu"
    groups = dict(res["groups"])
    assert any(g.startswith("encoder/layer") for g in groups)
    assert "decoder/upconv_3_1" in groups and "decoder/upconv_1_0" in groups
    assert all(g.count("/") <= 1 for g in groups)
    total = res["total_ms"]
    assert total > 0
    assert abs(sum(groups.values()) - total) <= 0.01 * total
    printed = sum(float(ln.split()[0]) for ln in out.splitlines()[1:])
    assert abs(printed - total) <= 0.01 * total
    with open(res["trace"]) as f:
        assert json.load(f)["traceEvents"]


def test_profile_device_module_paths_and_unattributed(tmp_path):
    gen = torch.Generator().manual_seed(0)
    enc = init_params(ResnetEncoder(18), gen).eval()
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), gen).eval()
    paths = {p for _, p in pd.module_paths("decoder", dec).values()}
    assert {"decoder", "decoder/upconv_4_0", "decoder/waveconv_4_ll",
            "decoder/upconv_1_1/conv/conv"} <= paths
    paths = {p for _, p in pd.module_paths("encoder", enc).values()}
    assert {"encoder", "encoder/conv1", "encoder/layer4/1/bn2"} <= paths
    x = torch.rand((1, H, W, 3), generator=gen)

    @torch.inference_mode()
    def fwd():
        return dec(enc(x * 2.0))     # the scaling runs outside every module

    events, names, _ = pd.collect_trace(
        fwd, {"encoder": enc, "decoder": dec}, 1, 1, str(tmp_path), "cpu")
    assert names == {"encoder", "decoder"}
    total, groups = pd.attribute(events, names, 1, "cpu")
    groups = dict(groups)
    assert set(groups) == {"encoder", "decoder", pd.UNATTRIBUTED}
    assert abs(sum(groups.values()) - total) <= 1e-9 * total
    # no hook outlives the trace
    assert not any(m._forward_pre_hooks for m in enc.modules())
    np.testing.assert_array_less(0, list(groups.values()))


def test_profile_device_cuda_attribution_skips_annotations():
    """The CUDA branch of `attribute` on recorded events: each device
    event counts once, under the range around the CUDA runtime call of
    its correlation id (an op may share that id: only a cuda* / cu* call
    launches); a range's annotation span is no kernel; events with no
    launcher in the trace are UNATTRIBUTED."""
    from types import SimpleNamespace as E

    from torch.autograd import DeviceType

    def cpu(name, id, parent=None):
        return E(name=name, id=id, cpu_parent=parent,
                 device_type=DeviceType.CPU)

    def gpu(name, id, us):
        return E(name=name, id=id, device_type=DeviceType.CUDA,
                 time_range=E(start=1000.0, end=1000.0 + us))

    dec = cpu("decoder", 1)
    up = cpu("decoder/upconv_3_1", 2, dec)
    conv = cpu("aten::cudnn_convolution", 3, up)
    events = [dec, up, conv,
              cpu("aten::add", 50, dec),              # shares an id with
              cpu("cudaLaunchKernel", 50, conv),      # this launch
              cpu("cuLaunchKernel", 51, conv),
              cpu("cudaLaunchKernel", 52, dec),
              gpu("decoder", 1, 900.0),               # annotations
              gpu("decoder/upconv_3_1", 2, 500.0),
              gpu("sm90_conv", 50, 300.0),
              gpu("fft_kernel", 51, 100.0),
              gpu("cat_kernel", 52, 60.0),
              gpu("memcpy", 99, 20.0)]                # launcher unseen
    names = {"decoder", "decoder/upconv_3_1"}
    total, groups = pd.attribute(events, names, iters=2, device="cuda")
    assert groups == [("decoder/upconv_3_1", 0.2), ("decoder", 0.03),
                      (pd.UNATTRIBUTED, 0.01)]
    assert total == pytest.approx(0.24)
