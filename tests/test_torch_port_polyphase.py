"""Port parity, `use_polyphase`: `ops/convops.upconv1_polyphase` and the
five decoder classes that take the flag, against the JAX package with
the flag set, and against the port without it (JAX's own contracts,
tests/test_decoders_kitti.py:154-177 and tests/test_decoders_nyu.py:
95-135), at the one-process parity tests' sizes.

Tolerances, each with its reason:
  * port vs JAX, both folded: KITTI outputs 1e-5 plus 1e-5 relative (the
    collapsed taps are summed alike; XLA and ATen sum the convs in other
    orders, as tests/test_torch_port_models.py finds), NYU 1e-4 plus
    1e-5 relative (tests/test_torch_port_nyu_models.py's dense bound: its
    seeded weights are N(0, 2 / fan_in), outputs of order 10);
  * masks and op counts exactly (KITTI's prescribed by mask_override,
    NYU's from the threshold at the seeds of the NYU parity tests);
  * folded vs the plain composition, in the port: 5e-5 for KITTI and 2e-5
    for NYU, JAX's own bounds (the fold reassociates the taps' sums), op
    counts at rtol 1e-6 as JAX's test;
  * thresh -1 sparse == dense with the fold, bit for bit (the all-ones
    masks multiply exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_nyu_models import CH, _load, random_vars
from wavelet_monodepth_tpu.models import decoders_nyu as jdec
from wavelet_monodepth_tpu.models.decoders_kitti import \
    DepthDecoder as JDepthDecoder
from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.ops import convops as jconv
from wavelet_monodepth_tpu_torch.models import decoders_nyu as tdec
from wavelet_monodepth_tpu_torch.models.decoders_kitti import (
    DepthDecoder, KittiWaveletDecoder)
from wavelet_monodepth_tpu_torch.ops import convops
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.utils import maskgen as tmg

torch.set_num_threads(1)
H, W, N = 64, 96, 2
CH18 = j_num_ch_enc(18)


def _t(a):
    return torch.from_numpy(np.array(a))


def _feats(channels, seed, draw="rand"):
    rng = np.random.RandomState(seed)
    return [getattr(rng, draw)(N, H // 2 ** (i + 1), W // 2 ** (i + 1), c)
            .astype(np.float32) for i, c in enumerate(channels)]


def _nyu_feats():
    """tests/test_torch_port_nyu_models.py's decoder features."""
    return _feats(CH, 5, "randn")


def _assert_outputs(ours: dict, ref: dict, atol: float, rtol: float = 1e-5):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        o = ours[k].numpy()
        assert o.shape == np.shape(v), k
        if k[0].endswith("mask") or k[0] in ("total_ops", "overflow"):
            np.testing.assert_array_equal(o, np.asarray(v), err_msg=str(k))
        else:
            np.testing.assert_allclose(o, np.asarray(v), atol=atol,
                                       rtol=rtol, err_msg=str(k))


@pytest.mark.parametrize("pad_mode", ["reflect", "replicate", "zero"])
def test_upconv1_polyphase_matches_jax_and_composition(pad_mode):
    """The op alone on OIHW weights: JAX's on HWIO within 1e-5, the plain
    upsample + concat + conv3x3 within 5e-5 (JAX's bound)."""
    rng = np.random.RandomState(2)
    x0 = rng.randn(N, 6, 8, 5).astype(np.float32)
    skip = rng.randn(N, 12, 16, 3).astype(np.float32)
    w = rng.randn(4, 8, 3, 3).astype(np.float32) * 0.3     # OIHW
    b = rng.randn(4).astype(np.float32)
    ref = jconv.upconv1_polyphase(jnp.asarray(x0), jnp.asarray(skip),
                                  jnp.asarray(w.transpose(2, 3, 1, 0)),
                                  jnp.asarray(b), pad_mode)
    ours = convops.upconv1_polyphase(_t(x0), _t(skip), _t(w), _t(b),
                                     pad_mode)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    from wavelet_monodepth_tpu_torch.ops.image import upsample_nearest2x
    plain = convops.conv3x3(torch.cat([upsample_nearest2x(_t(x0)),
                                       _t(skip)], -1), _t(w), _t(b),
                            pad_mode)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=5e-5)


@pytest.fixture(scope="module")
def kitti():
    feats = _feats(CH18, 3)
    jd = JDecoder(num_ch_enc=CH18, use_polyphase=True)
    dv = jax.tree_util.tree_map(np.asarray, JDecoder(num_ch_enc=CH18).init(
        jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats]))
    sd = ti.state_dicts_from_jax(None, dv)[1]
    on, off = (KittiWaveletDecoder(CH18, use_polyphase=p).eval()
               for p in (True, False))
    for dec in (on, off):
        dec.load_state_dict(sd, strict=True)
    masks = tmg.masks_at_density(tmg.synthetic_depth_scene(N, H, W, seed=3),
                                 0.10)[0]
    return dict(feats=feats, jd=jd, dv=dv, on=on, off=off, masks=masks)


def _run(dec, feats, **kw):
    with torch.no_grad():
        return dec([_t(f) for f in feats], **kw)


def test_kitti_polyphase_dense_matches_jax(kitti):
    ref = kitti["jd"].apply(kitti["dv"],
                            [jnp.asarray(f) for f in kitti["feats"]])
    ours = _run(kitti["on"], kitti["feats"])
    _assert_outputs(ours, ref, atol=1e-5)
    off = _run(kitti["off"], kitti["feats"])
    for s in range(4):
        np.testing.assert_allclose(ours[("disp", s)].numpy(),
                                   off[("disp", s)].numpy(), atol=5e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas2d"])
def test_kitti_polyphase_sparse_matches_jax(kitti, backend):
    """At the maskgen 10% masks: the fold on xla (masked through the
    low-res twin of the upsample mask), the kernel on pallas2d (no fold,
    as in JAX); outputs, masks and op counts as JAX's."""
    mo = kitti["masks"]
    ref = kitti["jd"].apply(
        kitti["dv"], [jnp.asarray(f) for f in kitti["feats"]],
        thresh_ratio=0.1, use_pallas=backend,
        mask_override={i: jnp.asarray(m) for i, m in mo.items()})
    ours = _run(kitti["on"], kitti["feats"], thresh_ratio=0.1,
                use_pallas=backend,
                mask_override={i: _t(m) for i, m in mo.items()})
    _assert_outputs(ours, ref, atol=1e-5)


def test_kitti_polyphase_threshold_and_identity(kitti):
    """JAX's contract in the port: at thresh 0.05 the fold stays within
    5e-5 of the plain composition with op counts at rtol 1e-6, and at
    thresh -1 the folded sparse decode equals the folded dense one bit for
    bit."""
    on = _run(kitti["on"], kitti["feats"], thresh_ratio=0.05)
    off = _run(kitti["off"], kitti["feats"], thresh_ratio=0.05)
    for s in range(4):
        np.testing.assert_allclose(on[("disp", s)].numpy(),
                                   off[("disp", s)].numpy(), atol=5e-5)
    np.testing.assert_allclose(on[("total_ops", -1)].numpy(),
                               off[("total_ops", -1)].numpy(), rtol=1e-6)
    dense = _run(kitti["on"], kitti["feats"])
    sparse = _run(kitti["on"], kitti["feats"], thresh_ratio=-1.0)
    for k, v in dense.items():
        assert torch.equal(sparse[k], v), k


def test_depth_decoder_polyphase_matches_jax():
    feats = _feats(CH18, 4)
    jf = [jnp.asarray(f) for f in feats]
    bdv = JDepthDecoder(num_ch_enc=CH18).init(jax.random.PRNGKey(0), jf)
    ref = JDepthDecoder(num_ch_enc=CH18, use_polyphase=True).apply(bdv, jf)
    sd = ti.state_dicts_from_jax(None, jax.tree_util.tree_map(np.asarray,
                                                              bdv))[1]
    on, off = (DepthDecoder(CH18, use_polyphase=p).eval()
               for p in (True, False))
    for dec in (on, off):
        dec.load_state_dict(sd, strict=True)
    ours, plain = _run(on, feats), _run(off, feats)
    _assert_outputs(ours, ref, atol=1e-5)
    for k, v in plain.items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), atol=5e-5)


@pytest.mark.parametrize("pad_mode", ["zero", "reflect"])
@pytest.mark.parametrize("masked", [False, True])
def test_upblock_polyphase_matches_jax(pad_mode, masked):
    """NYU's UpBlock with the fold, plain and masked through the low-res
    twin of its upsample mask (the sparse decoder's call)."""
    rng = np.random.RandomState(7)
    x = rng.randn(N, 8, 12, 16).astype(np.float32)
    skip = rng.randn(N, 16, 24, 8).astype(np.float32)
    kw, tkw = {}, {}
    if masked:
        raw = (rng.rand(N, 8, 12, 1) > 0.7).astype(np.float32)
        from wavelet_monodepth_tpu_torch.ops import sparse as sp
        from wavelet_monodepth_tpu_torch.ops.image import upsample_nearest2x
        m = _t(raw)
        masks = {"in_mask": sp.dilate_mask(m, 5),
                 "up_out_mask": sp.dilate_mask(upsample_nearest2x(m), 5),
                 "out_mask": sp.dilate_mask(upsample_nearest2x(m), 3),
                 "up_in_mask_lo": sp.dilate_mask(m, 3)}
        tkw = masks
        kw = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    jb = jdec.UpBlock(12, pad_mode, use_polyphase=True)
    v = jax.tree_util.tree_map(np.asarray, jb.init(
        jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(skip)))
    ref = jb.apply(v, jnp.asarray(x), jnp.asarray(skip), **kw)
    tb = tdec.UpBlock(24, 12, pad_mode, use_polyphase=True)
    p = v["params"]["convA"]
    with torch.no_grad():
        tb.convA.conv.weight.copy_(_t(p["kernel"].transpose(3, 2, 0, 1)))
        tb.convA.conv.bias.copy_(_t(p["bias"]))
        ours = tb(_t(x), _t(skip), **tkw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("cls", ["NyuDecoder", "NyuDecoder224",
                                 "NyuDecoderWave", "NyuDecoderWave224"])
def test_nyu_decoders_polyphase_match_jax(cls):
    """Each NYU decoder with the fold on its UpBlocks, dense, against
    JAX's and against the port without it (2e-5, JAX's bound)."""
    feats = _nyu_feats()
    jf = [jnp.asarray(f) for f in feats]
    dv = random_vars(getattr(jdec, cls)(num_ch_enc=CH).init, jf, seed=6)
    ref = getattr(jdec, cls)(num_ch_enc=CH, use_polyphase=True).apply(dv, jf)
    sd = ti.state_dicts_from_jax(None, dv)[1]
    on = _load(getattr(tdec, cls)(CH, use_polyphase=True), sd)
    off = _load(getattr(tdec, cls)(CH), sd)
    ours, plain = _run(on, feats), _run(off, feats)
    _assert_outputs(ours, ref, atol=1e-4)
    np.testing.assert_allclose(ours[("disp", 0)].numpy(),
                               plain[("disp", 0)].numpy(), atol=2e-5)


@pytest.mark.parametrize("backend", [False, "xla", "pallas2d"])
def test_nyu_wave_sparse_polyphase_matches_jax(backend):
    """NyuDecoderWave's sparse decode with the fold where JAX takes it (a
    false use_pallas: the string "xla" and the kernel backends keep the
    plain composition), the masks from its own threshold (as
    tests/test_torch_port_nyu_models.py's sparse parity): outputs, masks
    and op counts as JAX's; the fold within 2e-5 of the plain decode."""
    feats = _nyu_feats()
    jf = [jnp.asarray(f) for f in feats]
    dv = random_vars(jdec.NyuDecoderWave(num_ch_enc=CH).init, jf, seed=6)
    for k in ("wave1", "wave2", "wave3"):
        dv["params"][k]["kernel"] *= 0.05
    ref = jdec.NyuDecoderWave(num_ch_enc=CH, use_polyphase=True).apply(
        dv, jf, thresh_ratio=0.05, use_pallas=backend)
    sd = ti.state_dicts_from_jax(None, dv)[1]
    on = _load(tdec.NyuDecoderWave(CH, use_polyphase=True), sd)
    off = _load(tdec.NyuDecoderWave(CH), sd)
    ours = _run(on, feats, thresh_ratio=0.05, use_pallas=backend)
    plain = _run(off, feats, thresh_ratio=0.05, use_pallas=backend)
    for s in (0, 1):
        m = ours[("wavelet_mask", s)]
        assert 0.0 < float(m.mean()) < 1.0, s
        assert torch.equal(m, plain[("wavelet_mask", s)]), s
    _assert_outputs(ours, ref, atol=1e-5)
    for s in range(4):
        np.testing.assert_allclose(ours[("disp", s)].numpy(),
                                   plain[("disp", s)].numpy(), atol=2e-5)
