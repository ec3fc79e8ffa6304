"""Port parity, bfloat16: wavelet_monodepth_tpu_torch's bf16 serving
(`utils/precision.py`, `tools/infer.py --bfloat16`), its bf16
mixed-precision train step (`train/kitti.py`) and the bench twin
(`tools/bench.py`) against the JAX package's, at 64x96, batch 2, on the
same weights (crossed by tools/torch_import.py before the cast) and
inputs from numpy seeds.

Tolerances, each with its reason:
  * disparity, bf16 against JAX's bf16 forward on every backend: max
    0.05 and mean 0.01 at every scale (tests/test_bf16.py's bounds for
    bf16 against f32; both run the convs in bf16, from sums taken in
    different orders, and JAX folds the input normalisation into the
    stem at inference); masks, op counts and ("overflow", s) exactly;
  * the mixed-precision step: losses within 1e-2 relative of JAX's
    (worst observed 3.2e-3, reproj_loss/0); BN running means within
    6e-2 and variances within 2e-2 of each tensor's largest value
    (worst observed 2.7e-2 and 9.6e-3, layer4: bf16 activations
    reach the float32 statistics after different roundings);
  * dtypes exactly, key for key.
"""

import copy
import os

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
from wavelet_monodepth_tpu.ops import augment as jaug
from wavelet_monodepth_tpu.ops import geometry as jgeo
from wavelet_monodepth_tpu.train.kitti import KittiTrainSetup as JSetup
from wavelet_monodepth_tpu.utils import precision as jprec
from wavelet_monodepth_tpu.utils.config import KittiOptions as JOptions
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.ops import augment as taug
from wavelet_monodepth_tpu_torch.ops import geometry as tgeo
from wavelet_monodepth_tpu_torch.tools import bench as tbench
from wavelet_monodepth_tpu_torch.tools import infer as tinfer
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup as TSetup
from wavelet_monodepth_tpu_torch.utils import maskgen as tmg
from wavelet_monodepth_tpu_torch.utils import precision as tprec
from wavelet_monodepth_tpu_torch.utils.config import KittiOptions as TOptions

torch.set_num_threads(1)
H, W, N = 64, 96, 2
BF16 = torch.bfloat16
DISP_MAX, DISP_MEAN = 0.05, 0.01


@pytest.fixture(scope="module")
def models():
    """Random JAX weights, their bf16 cast, the port's modules holding the
    same weights cast to bf16, two images and 10% maskgen masks."""
    img = np.random.RandomState(0).rand(N, H, W, 3).astype(np.float32)
    enc, dec = JEncoder(num_layers=18), JDecoder(num_ch_enc=j_num_ch_enc(18))
    ev = enc.init(jax.random.PRNGKey(0), jnp.asarray(img[:1]))
    dv = dec.init(jax.random.PRNGKey(1), enc.apply(ev, jnp.asarray(img[:1])))
    tenc = ResnetEncoder(18).eval()
    tdec = KittiWaveletDecoder(tenc.num_ch_enc).eval()
    ti.load_state_dicts(tenc, tdec, *ti.state_dicts_from_jax(ev, dv))
    disp = tmg.synthetic_depth_scene(N, H, W, seed=3)
    masks, ratio, _ = tmg.masks_at_density(disp, 0.10)
    return {"img": img, "enc": enc, "dec": dec, "tenc32": tenc,
            "tdec32": tdec, "evb": jprec.cast_floats(ev, jnp.bfloat16),
            "dvb": jprec.cast_floats(dv, jnp.bfloat16),
            "tenc": tprec.cast_floats(copy.deepcopy(tenc), BF16),
            "tdec": tprec.cast_floats(copy.deepcopy(tdec), BF16),
            "masks": masks, "ratio": ratio}


def _forwards(m, thresh=None, backend=False, cap=0.5):
    """(port output dict, JAX output dict), both through their
    wrap_forward_bf16."""
    def jfwd(x):
        feats = m["enc"].apply(m["evb"], x)
        if thresh is None:
            return m["dec"].apply(m["dvb"], feats)
        return m["dec"].apply(
            m["dvb"], feats, thresh_ratio=thresh, use_pallas=backend,
            compact_cap=cap,
            mask_override={i: jnp.asarray(v) for i, v in m["masks"].items()})

    @torch.no_grad()
    def tfwd(x):
        feats = m["tenc"](x)
        if thresh is None:
            return m["tdec"](feats)
        return m["tdec"](
            feats, thresh_ratio=thresh, use_pallas=backend, compact_cap=cap,
            mask_override={i: torch.from_numpy(v)
                           for i, v in m["masks"].items()})

    return (tprec.wrap_forward_bf16(tfwd)(torch.from_numpy(m["img"])),
            jprec.wrap_forward_bf16(jfwd)(jnp.asarray(m["img"])))


def _assert_disp_close(ours, ref):
    for s in range(4):
        d = ours[("disp", s)]
        assert d.dtype == torch.float32
        err = np.abs(d.numpy() - np.asarray(ref[("disp", s)]))
        assert err.max() < DISP_MAX and err.mean() < DISP_MEAN, (s, err.max(),
                                                                 err.mean())


def test_cast_floats_only_touches_floats():
    """Floats are cast, ints (num_batches_tracked too) are not, as JAX's
    cast_floats does to its pytrees."""
    bn = torch.nn.BatchNorm2d(4)
    tprec.cast_floats(bn, BF16)
    assert bn.weight.dtype == bn.running_var.dtype == BF16
    assert bn.num_batches_tracked.dtype == torch.int64
    tree = {"a": torch.ones(2, 2), "b": torch.ones(2, dtype=torch.int32),
            "c": 3, "d": [torch.ones(1, dtype=torch.float64)]}
    out = tprec.cast_floats(tree, BF16)
    ref = jprec.cast_floats({"a": jnp.ones((2, 2)),
                             "b": jnp.ones((2,), jnp.int32), "c": 3,
                             "d": [jnp.ones((1,))]}, jnp.bfloat16)
    assert out["a"].dtype == BF16 and ref["a"].dtype == jnp.bfloat16
    assert out["b"].dtype == torch.int32 and ref["b"].dtype == jnp.int32
    assert out["c"] == ref["c"] == 3
    assert out["d"][0].dtype == BF16 and tree["a"].dtype == torch.float32
    outs = tprec.wrap_forward_bf16(lambda x: {"y": x, "n": x.sum().int()})(
        torch.ones(2))
    assert outs["y"].dtype == torch.float32 and outs["n"].dtype == torch.int32


def test_bf16_dense_forward_matches_jax(models):
    ours, ref = _forwards(models)
    assert set(ours) == set(ref)
    assert all(v.dtype == torch.float32 for v in ours.values())
    _assert_disp_close(ours, ref)


@pytest.mark.parametrize("backend", [False, "compact", "sites", "capacity"])
def test_bf16_sparse_backends_match_jax(models, backend):
    """mask_override at the 10% maskgen point, compact_cap 0.5 (where the
    compacted backends drop tiles: the dropped ones must be JAX's)."""
    ours, ref = _forwards(models, models["ratio"], backend)
    assert set(ours) == set(ref)
    _assert_disp_close(ours, ref)
    for k in ref:
        if k[0] in ("total_ops", "overflow") or k[0].endswith("mask"):
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                          err_msg=str(k))


@pytest.mark.parametrize("backend", [True, "pallas2d"])
def test_tile_conv_backends_raise_in_bf16(models, backend):
    """JAX cannot trace its tile-sparse conv kernels in bf16 (their
    float32 scratch); the port raises for them too, before any work."""
    m = models
    feats = m["enc"].apply(m["evb"], jnp.asarray(m["img"], jnp.bfloat16))
    with pytest.raises(Exception, match="mismatched|dtype|type"):
        jax.eval_shape(lambda f: m["dec"].apply(
            m["dvb"], f, thresh_ratio=0.1, use_pallas=backend), feats)
    with torch.no_grad():
        tfeats = m["tenc"](torch.from_numpy(m["img"]).to(BF16))
    with pytest.raises(NotImplementedError, match="float32 only"):
        m["tdec"](tfeats, thresh_ratio=0.1, use_pallas=backend)


def test_backproject_pixel_grid_follows_depth_dtype():
    """JAX builds the backprojection's pixel grid in depth's dtype, so a
    bf16 depth puts 224 of 640 columns up to 2 px off (ROADMAP.md Queue
    3); the port reproduces it and promotes against float32 inv_K."""
    depth = np.full((1, 2, 640, 1), 3.0, np.float32)
    inv_k = np.repeat(np.eye(4, dtype=np.float32)[None], 1, 0)
    ours = tgeo.backproject_depth(torch.from_numpy(depth).to(BF16),
                                  torch.from_numpy(inv_k))
    ref = jgeo.backproject_depth(jnp.asarray(depth, jnp.bfloat16),
                                 jnp.asarray(inv_k))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    x = ours[0, 0, :640].numpy() / 3.0
    off = np.abs(x - np.arange(640))
    assert (off > 0).sum() == 224 and off.max() == 2.0


@pytest.fixture(scope="module")
def mixed_step():
    """One bf16 mixed-precision step of both frameworks (stereo + hints,
    F.grid_sample / the gather), and each one's forward dtypes."""
    from test_torch_port_train import (FIELDS, _batch, _conditioned,
                                       _cross_weights, _jax_noise)
    jsetup = JSetup(JOptions(**FIELDS, stereo_warp_kernel="off",
                             bfloat16=True), steps_per_epoch=10)
    jstate = _conditioned(jsetup.init_state(jax.random.PRNGKey(0)))
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, jlosses = jax.jit(jsetup.make_train_step(
        mixed_precision=True))(jstate, jbatch, rng)

    def jforward(params, inputs):
        ins = jaug.expand_batch(inputs, jnp)
        ins = {k: v.astype(jnp.bfloat16) if k[0] == "color_aug" else v
               for k, v in ins.items()}
        out, losses, _ = jsetup.forward(
            jprec.cast_floats(params, jnp.bfloat16), jstate.batch_stats, ins,
            rng, train=True)
        return out, losses
    jdtypes = jax.eval_shape(jforward, jstate.params, jbatch)

    tsetup = TSetup(TOptions(**FIELDS, stereo_warp_kernel="off",
                             device="cpu", bfloat16=True), steps_per_epoch=10)
    tstate = tsetup.init_state()
    _cross_weights(jstate, tstate)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    noise = _jax_noise(rng, (N, H, W, 1))
    tlosses = tsetup.train_step(tstate, tbatch, noise)
    stats = {k: v.clone() for k, v in tstate.encoder.state_dict().items()}
    # the forward alone, for its dtypes (it moves the BN statistics again,
    # so they were kept above)
    params = tuple({n: p.detach().to(BF16) for n, p in m.named_parameters()}
                   for m in (tstate.encoder, tstate.decoder))
    ins = {k: v.to(BF16) if k[0] == "color_aug" else v
           for k, v in taug.expand_batch(tbatch).items()}
    with torch.no_grad():
        tdtypes = tsetup.forward(tstate, ins, noise, train=True,
                                 params=params)
    jstats = ti.state_dicts_from_jax(
        {"params": new_state.params["encoder"],
         "batch_stats": new_state.batch_stats["encoder"]},
        {"params": new_state.params["depth"]})[0]
    return dict(jlosses=jax.device_get(jlosses), tlosses=tlosses,
                tstate=tstate, tstats=stats, jstats=jstats,
                jdtypes=jdtypes, tdtypes=tdtypes,
                jparams=jax.device_get(new_state.params))


def test_mixed_precision_step_matches_jax(mixed_step):
    """Losses close to JAX's and float32; float32 gradients, master
    parameters, Adam moments and BN running statistics, the statistics
    close to JAX's."""
    jl, tl = mixed_step["jlosses"], mixed_step["tlosses"]
    assert set(jl) == set(tl)
    for k in jl:
        assert tl[k].dtype == torch.float32
        ref = float(jl[k])
        assert abs(float(tl[k]) - ref) <= 1e-2 * abs(ref), (k, float(tl[k]),
                                                             ref)
    state = mixed_step["tstate"]
    for m in (state.encoder, state.decoder):
        for name, p in m.named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, name
    for moments in state.optimizer.state_dict()["state"].values():
        assert all(v.dtype == torch.float32 for v in moments.values())
    for k, v in mixed_step["tstats"].items():
        if k.endswith(("running_mean", "running_var")):
            ref = np.asarray(mixed_step["jstats"][k])
            assert v.dtype == torch.float32 and ref.dtype == np.float32
            tol = 6e-2 if k.endswith("mean") else 2e-2
            err = np.abs(v.numpy() - ref).max()
            assert err <= tol * np.abs(ref).max(), (k, err)
        elif k.endswith("num_batches_tracked"):
            assert int(v) == 1


def test_mixed_precision_dtype_map_matches_jax(mixed_step):
    """Every output and loss of the mixed-precision forward has JAX's
    dtype, key for key: bf16 disparities and depths, float32 sample
    grids, warped images and losses (where torch and JAX promote
    differently, a 0-dim float32 tensor would keep a bf16 result)."""
    (jout, jlosses), (tout, tlosses) = (mixed_step["jdtypes"],
                                        mixed_step["tdtypes"])

    def name(dt):
        return str(dt).replace("torch.", "")

    for ours, ref in ((tout, jout), (tlosses, jlosses)):
        assert set(ours) == set(ref)
        assert {k: name(v.dtype) for k, v in ours.items()} == {
            k: name(v.dtype) for k, v in ref.items()}
    for s in range(4):
        assert tout[("depth", 0, s)].dtype == BF16
        assert tout[("sample", "s", s)].dtype == torch.float32


def test_infer_main_bf16_writes_files(models, tmp_path):
    """infer.main --bfloat16 --device cpu over a reference checkpoint
    writes the f32 files of an f32 run, its disparities within the bf16
    bounds of the f32 run's."""
    ti.save_reference_checkpoint(str(tmp_path / "weights"),
                                 models["tenc32"], models["tdec32"], H, W)
    imgs = (tmg.scene_image(tmg.synthetic_depth_scene(1, 80, 120, seed=5),
                            seed=5) * 255).astype(np.uint8)
    outs = {}
    for run, extra in (("f32", []), ("bf16", ["--bfloat16"])):
        d = tmp_path / run
        d.mkdir()
        Image.fromarray(imgs[0]).save(d / "scene_0.png")
        tinfer.main(["--image_path", str(d), "--torch_model_path",
                     str(tmp_path / "weights"), "--device", "cpu"] + extra)
        outs[run] = d
    files = sorted(os.listdir(outs["f32"]))
    assert sorted(os.listdir(outs["bf16"])) == files
    assert "scene_0_disp.jpeg" in files and "scene_0_disp.npy" in files
    for f in files:
        if f.endswith(".npy"):
            a, b = np.load(outs["bf16"] / f), np.load(outs["f32"] / f)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    # scaled disparity: disp * (10 - 0.01) + 0.01
    err = np.abs(np.load(outs["bf16"] / "scene_0_disp.npy")
                 - np.load(outs["f32"] / "scene_0_disp.npy")) / 9.99
    assert err.max() < DISP_MAX and err.mean() < DISP_MEAN


# bench.py's result keys (`bench.py:234-263`)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA_KEYS = {
    "dtype", "dense_bf16_fps", "dense_f32_fps", "sparse_f32_fps",
    "sparse_f32_vs_dense_f32", "sparse_thresh02_f32_fps", "density",
    "mask_source", "sparse_backend", "batch", "measurement", "device",
    "batch1_ms_dense_bf16", "batch1_ms_sparse_bf16",
    "tflops_effective_dense_bf16", "gflop_per_frame"}


def test_bench_twin_has_bench_keys_on_cpu(capsys):
    res = tbench.main(["--batch", "2", "--height", str(H), "--width",
                       str(W), "--iters", "1", "--windows", "1",
                       "--no-extra"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert set(res) == BENCH_KEYS and BENCH_EXTRA_KEYS <= set(res["extra"])
    ex = res["extra"]
    assert ex["batch"] == 2 and 0.05 < ex["density"] < 0.2
    assert res["value"] > 0 and ex["gflop_per_frame"] > 0
    assert res["vs_baseline"] == pytest.approx(
        res["value"] / ex["dense_bf16_fps"])
    assert set(ex["cells"]) == {"dense_f32", "sparse_f32", "dense_bf16",
                                "sparse_bf16", "sparse_thresh02_f32",
                                "batch1_dense_bf16", "batch1_sparse_bf16"}


def test_bench_refuses_a_spreading_cell():
    """A cell whose windows spread past 10% is measured again, twice, and
    then reports null with its spread, never a number."""
    import time
    calls = {"n": 0}

    def slowing():               # each call sleeps 1 ms longer
        calls["n"] += 1
        time.sleep(0.001 * calls["n"])

    out = tbench.measure({"slowing": slowing}, {"slowing": 1}, 3,
                         torch.device("cpu"))["slowing"]
    assert out["ms"] is None and out["spread"] > tbench.MAX_SPREAD
    assert out["attempts"] == 1 + tbench.RETRIES
    assert len(out["windows"]) == 3
