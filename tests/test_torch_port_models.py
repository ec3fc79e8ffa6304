"""Port parity, models: the ResNet18 encoder, the decoder layers and the
KITTI wavelet decoder of wavelet_monodepth_tpu_torch against the JAX
modules, with the JAX weights carried over by the port's weight bridge
(tools/torch_import.py), at 64x96 (as tests/test_pallas_conv.py).

Tolerances: encoder features 1e-4 (the JAX encoder folds its input
normalisation into the stem BN, the port does not: equal up to f32
reassociation); decoder outputs 1e-5 given the same features; masks and
op counts exactly, with masks prescribed by `mask_override` (a computed
threshold can flip a mask bit where |yh| is within rounding of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.models import layers as jlayers
from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu_torch.models import layers as tlayers
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.utils import maskgen as tmg

torch.set_num_threads(1)
H, W, N = 64, 96, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_bn(enc_vars, seed=0):
    """Non-trivial BN affine + running stats so the bridge of every BN
    field is exercised."""
    rng = np.random.RandomState(seed)

    def walk(p, s):
        for k in p:
            if k == "bn":
                c = p[k]["scale"].shape[0]
                p[k]["scale"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
                p[k]["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
                s[k]["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
                s[k]["var"] = (1 + 0.2 * rng.rand(c)).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    ev = {"params": _np_tree(enc_vars["params"]),
          "batch_stats": _np_tree(enc_vars["batch_stats"])}
    ev = jax.tree_util.tree_map(np.array, ev)
    walk(ev["params"], ev["batch_stats"])
    return ev


@pytest.fixture(scope="module")
def jax_model():
    img = np.random.RandomState(0).rand(N, H, W, 3).astype(np.float32)
    enc = JEncoder(num_layers=18)
    ev = _perturb_bn(enc.init(jax.random.PRNGKey(0), jnp.asarray(img[:1])))
    feats = enc.apply(ev, jnp.asarray(img))
    dec = JDecoder(num_ch_enc=j_num_ch_enc(18))
    dv = _np_tree(dec.init(jax.random.PRNGKey(1), feats))
    return {"img": img, "enc": enc, "ev": ev, "dec": dec, "dv": dv,
            "feats": [np.array(f) for f in feats]}


@pytest.fixture(scope="module")
def port_model(jax_model):
    enc = ResnetEncoder(18).eval()
    dec = KittiWaveletDecoder(enc.num_ch_enc).eval()
    enc_sd, dec_sd = ti.state_dicts_from_jax(jax_model["ev"],
                                             jax_model["dv"])
    ti.load_state_dicts(enc, dec, enc_sd, dec_sd)
    return enc, dec


@pytest.fixture(scope="module")
def edge_masks():
    disp = tmg.synthetic_depth_scene(N, H, W, seed=3)
    masks, _, _ = tmg.masks_at_density(disp, 0.10)
    return masks


def _feats_t(jax_model):
    return [torch.from_numpy(f) for f in jax_model["feats"]]


def _assert_outputs(ours, ref, atol):
    """Masks, op counts and overflow exactly; floats within atol plus 1e-5
    relative: LL values reach 2^4, where the f32 spacing is 1.9e-6, and
    XLA-CPU and ATen sum the 3x3 convs in different orders."""
    for k, v in ref.items():
        assert k in ours, k
        o = ours[k].numpy()
        if k[0].endswith("mask") or k[0] in ("total_ops", "overflow"):
            np.testing.assert_array_equal(o, np.asarray(v), err_msg=str(k))
        else:
            np.testing.assert_allclose(o, np.asarray(v), atol=atol,
                                       rtol=1e-5, err_msg=str(k))


def test_bridge_equals_jax_exporter_and_loads_strict(jax_model):
    enc_sd, dec_sd = ti.state_dicts_from_jax(jax_model["ev"],
                                             jax_model["dv"])
    for ours, ref in ((enc_sd, jti.export_resnet_encoder(jax_model["ev"])),
                      (dec_sd, jti.export_kitti_wavelet_decoder(
                          jax_model["dv"]))):
        assert list(ours) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), ref[k],
                                          err_msg=k)
    enc = ResnetEncoder(18)
    dec = KittiWaveletDecoder(enc.num_ch_enc)
    assert set(dec.state_dict()) == set(dec_sd)
    report = ti.load_state_dicts(enc, dec, enc_sd, dec_sd)
    assert report["dropped"] == []
    assert report["filled"] == sorted(k for k in enc.state_dict()
                                      if k.endswith("num_batches_tracked"))
    assert len(report["filled"]) == 20


def test_reference_checkpoint_roundtrip(tmp_path, port_model):
    """A reference-layout folder (torchvision's fc, metadata ints) loads
    with the extras dropped and reported."""
    enc, dec = port_model
    ti.save_reference_checkpoint(str(tmp_path), enc, dec, 192, 640)
    enc_sd, dec_sd = ti.load_reference_checkpoint(str(tmp_path))
    enc_sd["encoder.fc.weight"] = torch.zeros(1000, 512)
    enc_sd["encoder.fc.bias"] = torch.zeros(1000)
    enc2 = ResnetEncoder(18)
    dec2 = KittiWaveletDecoder(enc2.num_ch_enc)
    report = ti.load_state_dicts(enc2, dec2, enc_sd, dec_sd)
    assert report["meta"] == {"height": 192, "width": 640, "use_stereo": 1}
    assert report["dropped"] == ["encoder.fc.bias", "encoder.fc.weight",
                                 "height", "use_stereo", "width"]
    assert report["filled"] == []
    for k, v in enc.state_dict().items():
        assert torch.equal(enc2.state_dict()[k], v), k


def test_encoder_features(jax_model, port_model):
    enc, _ = port_model
    with torch.no_grad():
        ours = enc(torch.from_numpy(jax_model["img"]))
    assert len(ours) == 5
    for i, (o, r) in enumerate(zip(ours, jax_model["feats"])):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, atol=1e-4, rtol=1e-4,
                                   err_msg=f"feature {i}")


def test_decoder_dense(jax_model, port_model):
    _, dec = port_model
    ref = jax_model["dec"].apply(jax_model["dv"],
                                 [jnp.asarray(f) for f in jax_model["feats"]])
    with torch.no_grad():
        ours = dec(_feats_t(jax_model))
    assert set(ours) == set(ref)
    _assert_outputs(ours, ref, atol=1e-5)


@pytest.mark.parametrize("backend", [False, True, "pallas2d"])
def test_decoder_sparse_backends_at_edge_masks(jax_model, port_model,
                                              edge_masks, backend):
    """Sparse decode at the maskgen 10% operating point on each backend:
    disp/wavelets within 1e-5, masks and op counts equal (JAX's kernels in
    interpret mode; the port's wrappers on their plain version)."""
    _, dec = port_model
    ratio = 0.1
    ref = jax_model["dec"].apply(
        jax_model["dv"], [jnp.asarray(f) for f in jax_model["feats"]],
        thresh_ratio=ratio, use_pallas=backend,
        mask_override={i: jnp.asarray(m) for i, m in edge_masks.items()})
    with torch.no_grad():
        ours = dec(_feats_t(jax_model), thresh_ratio=ratio,
                   use_pallas=backend,
                   mask_override={i: torch.from_numpy(m)
                                  for i, m in edge_masks.items()})
    assert set(ours) == set(ref)
    _assert_outputs(ours, ref, atol=1e-5)


@pytest.mark.parametrize("scales", [(2,), (1, 3)])
def test_decoder_sparse_scales_subset(jax_model, port_model, edge_masks,
                                      scales):
    """Scales outside sparse_scales run dense with masked coefficients and
    dense op counts."""
    _, dec = port_model
    ref = jax_model["dec"].apply(
        jax_model["dv"], [jnp.asarray(f) for f in jax_model["feats"]],
        thresh_ratio=0.1, sparse_scales=scales,
        mask_override={i: jnp.asarray(m) for i, m in edge_masks.items()})
    with torch.no_grad():
        ours = dec(_feats_t(jax_model), thresh_ratio=0.1,
                   sparse_scales=scales, use_pallas="pallas2d",
                   mask_override={i: torch.from_numpy(m)
                                  for i, m in edge_masks.items()})
    _assert_outputs(ours, ref, atol=1e-5)


def test_decoder_threshold_path(jax_model, port_model):
    """Computed thresholds: scale-3 masks agree except where max |yh| lies
    within 1e-5 of the per-image threshold; where all masks agree, disp
    agrees within 1e-5."""
    _, dec = port_model
    ratio = 0.05
    ref = jax_model["dec"].apply(
        jax_model["dv"], [jnp.asarray(f) for f in jax_model["feats"]],
        thresh_ratio=ratio)
    with torch.no_grad():
        ours = dec(_feats_t(jax_model), thresh_ratio=ratio)
    yl = np.asarray(ref[("wavelets", 2, "LL")])   # yl after scale 3
    yh = np.concatenate([np.asarray(ref[("wavelets", 3, b)])
                         for b in ("LH", "HL", "HH")], -1)
    thresh = (yl.max(axis=(1, 2, 3)) - yl.min(axis=(1, 2, 3))) * ratio
    margin = np.abs(np.abs(yh).max(-1) - thresh[:, None, None])
    raw_t = ours[("wavelet_mask", 2)].numpy()[:, ::2, ::2, 0]
    raw_j = np.asarray(ref[("wavelet_mask", 2)])[:, ::2, ::2, 0]
    assert np.all((raw_t == raw_j) | (margin < 1e-5))
    if all(np.array_equal(ours[k].numpy(), np.asarray(ref[k]))
           for k in ref if k[0].endswith("mask")):
        _assert_outputs(ours, ref, atol=1e-5)


def test_thresh_minus1_sparse_equals_dense_bitwise(jax_model, port_model):
    _, dec = port_model
    feats = _feats_t(jax_model)
    with torch.no_grad():
        dense = dec(feats)
        sparse = dec(feats, thresh_ratio=-1.0)
        kern = dec(feats, thresh_ratio=-1.0, use_pallas="pallas2d")
    for s in range(4):
        assert torch.equal(sparse[("disp", s)], dense[("disp", s)])
        for b in ("LL", "LH", "HL", "HH"):
            k = ("wavelets", s, b)
            assert torch.equal(sparse[k], dense[k]), k
        # the kernel backend's plain version uses the Pallas epilogues
        np.testing.assert_allclose(kern[("disp", s)].numpy(),
                                   dense[("disp", s)].numpy(), atol=1e-6)


def test_cpu_sparse_forward_launches_no_kernel(
        jax_model, port_model, edge_masks):
    """On the CPU nothing is launched; the routing is counted on the card
    by chip_smoke.py (12 per request)."""
    _, dec = port_model
    tsc.reset_launches()
    with torch.no_grad():
        dec(_feats_t(jax_model), thresh_ratio=0.1, use_pallas=True)
    assert sum(tsc.launches.values()) == 0


@pytest.mark.parametrize("backend", [False, "xla", True, "pallas",
                                     "pallas2d"])
@pytest.mark.parametrize("masked", [False, True])
def test_layers_match_jax(backend, masked):
    """Conv3x3 / ConvBlock / WaveConv with the same weights and masks on
    each backend."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 72, 6).astype(np.float32)
    mi = (rng.rand(2, 16, 72, 1) > 0.5).astype(np.float32) if masked else None
    mo = (rng.rand(2, 16, 72, 1) > 0.7).astype(np.float32) if masked else None
    jm = (lambda a: None if a is None else jnp.asarray(a))
    tm = (lambda a: None if a is None else torch.from_numpy(a))

    blk = jlayers.ConvBlock(5, "reflect")
    bv = _np_tree(blk.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    tblk = tlayers.ConvBlock(6, 5, "reflect")
    tblk.conv.conv.weight.data = torch.from_numpy(np.ascontiguousarray(
        np.transpose(bv["params"]["conv"]["kernel"], (3, 2, 0, 1))))
    tblk.conv.conv.bias.data = torch.from_numpy(
        np.array(bv["params"]["conv"]["bias"]))
    ref = blk.apply(bv, jnp.asarray(x), jm(mi), jm(mo), use_pallas=backend)
    with torch.no_grad():
        ours = tblk(torch.from_numpy(x), tm(mi), tm(mo), use_pallas=backend)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)

    wc = jlayers.WaveConv(4, 3)
    wv = _np_tree(wc.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    twc = tlayers.WaveConv(6, 4, 3)
    for idx, name in ((0, "squeeze"), (2, "conv")):
        p = wv["params"][name]
        twc[idx].conv.weight.data = torch.from_numpy(np.ascontiguousarray(
            np.transpose(p["kernel"], (3, 2, 0, 1))))
        twc[idx].conv.bias.data = torch.from_numpy(np.array(p["bias"]))
    ref = wc.apply(wv, jnp.asarray(x), jm(mi), jm(mo), use_pallas=backend)
    with torch.no_grad():
        ours = twc(torch.from_numpy(x), tm(mi), tm(mo), use_pallas=backend)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ResnetEncoder(50)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KittiWaveletDecoder((64, 64, 128, 256, 512), use_polyphase=True)
