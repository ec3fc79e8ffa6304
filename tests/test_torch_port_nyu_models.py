"""Port parity, the NYUv2 models: DenseNet161 and MobileNetV2 (both
last layers) of wavelet_monodepth_tpu_torch against the JAX encoders at
64x96, the five NYU decoders (dense and depthwise variants) on narrow
encoder widths, NyuDecoderWave's sparse decode on every kernel backend,
and the weight bridge against JAX's exporters, key for key.

Weights are seeded numpy trees of the JAX modules' own shapes
(`jax.eval_shape` of their init: an eager flax init of DenseNet161 takes
over a minute on the CPU), carried into the port by its bridge with
strict loads. The JAX side runs on the CPU with Pallas in interpret mode.

Tolerances: features and dense outputs atol 1e-4, rtol 1e-5 (XLA and
ATen sum convolutions in different orders); sparse outputs 1e-5 against
the same backend in JAX and against the port's xla backend, masks and op
counts exact; threshold -1 sparse equals dense bit for bit; a batched
sparse decode equals its batch-1 runs with exact masks and op counts,
outputs to 1e-4 (ATen picks other conv algorithms per batch size).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.models import decoders_nyu as jdec
from wavelet_monodepth_tpu.models import factory as jfactory
from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JKitti
from wavelet_monodepth_tpu.models.densenet import DenseNet161Encoder as JDense
from wavelet_monodepth_tpu.models.mobilenetv2 import \
    MobileNetV2Encoder as JMobile
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.utils.precision import cast_floats as jcast
from wavelet_monodepth_tpu_torch.models import decoders_nyu as tdec
from wavelet_monodepth_tpu_torch.models import factory
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.densenet import DenseNet161Encoder
from wavelet_monodepth_tpu_torch.models.mobilenetv2 import MobileNetV2Encoder
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.utils.precision import cast_floats

torch.set_num_threads(1)
H, W, N = 64, 96, 2
# narrow encoder widths for the decoders: f = 32, so NyuDecoder224's
# conv5 keeps f // 32 = 1 channel
CH = (8, 8, 16, 16, 64)
BACKENDS = (False, True, "pallas2d", "capacity")


def random_vars(init, *args, seed: int):
    """numpy variables with the shapes of init(key, *args): conv kernels
    N(0, 2 / fan_in), biases and BN shifts 0.1 N(0, 1), BN scales
    1 + 0.1 N(0, 1), running means 0.1 N(0, 1), variances 1 + 0.2 U."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            v = 1 + 0.2 * rng.rand(*s.shape)
        elif name == "scale":
            v = 1 + 0.1 * rng.randn(*s.shape)
        elif name in ("mean", "bias"):
            v = 0.1 * rng.randn(*s.shape)
        else:
            v = rng.randn(*s.shape) * (2.0 / np.prod(s.shape[:-1])) ** 0.5
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _load(module, sd):
    fitted = dict(sd)
    for k in module.state_dict():
        if k.endswith("num_batches_tracked"):
            fitted[k] = torch.zeros((), dtype=torch.long)
    module.load_state_dict(fitted, strict=True)
    return module.eval()


def _port_feats(enc, img):
    with torch.no_grad():
        return [f.numpy() for f in enc(torch.from_numpy(img))]


def _close(ours, ref, atol=1e-4, rtol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=str(what))


# --- encoders ----------------------------------------------------------------

@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).rand(N, H, W, 3).astype(np.float32)


@pytest.fixture(scope="module")
def densenet(image):
    x = jnp.asarray(image)
    ev = random_vars(JDense().init, x[:1], seed=1)
    feats = {flag: [np.asarray(f) for f in jax.jit(
        JDense(normalize_input=flag).apply)(ev, x)]
        for flag in (False, True)}
    return ev, feats


@pytest.mark.parametrize("normalize_input", [False, True])
def test_densenet_features_equal_jax(densenet, image, normalize_input):
    ev, feats = densenet
    enc = _load(DenseNet161Encoder(normalize_input),
                ti.state_dicts_from_jax(ev, None)[0])
    ours = _port_feats(enc, image)
    assert tuple(f.shape[-1] for f in ours) == enc.num_ch_enc == \
        (96, 96, 192, 384, 2208)
    for k, (o, r) in enumerate(zip(ours, feats[normalize_input])):
        assert o.shape == r.shape, k
        _close(o, r, what=f"feature {k}")


def test_densenet_bridge_equals_jax_exporter(densenet):
    ev, _ = densenet
    ours = ti.state_dicts_from_jax(ev, None)[0]
    ref = jti.export_densenet_encoder(ev)
    assert [f"encoder.{k}" for k in ours] == list(ref)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[f"encoder.{k}"])
    own = set(DenseNet161Encoder().state_dict())
    assert {k for k in own if not k.endswith("num_batches_tracked")} \
        == set(ours)


@pytest.mark.parametrize("use_last_layer", [True, False])
def test_mobilenet_features_and_bridge_equal_jax(image, use_last_layer):
    x = jnp.asarray(image)
    jenc = JMobile(use_last_layer=use_last_layer)
    ev = random_vars(jenc.init, x[:1], seed=2)
    ref = jax.jit(jenc.apply)(ev, x)
    sd = ti.state_dicts_from_jax(ev, None)[0]
    enc = _load(MobileNetV2Encoder(use_last_layer), sd)
    ours = _port_feats(enc, image)
    assert tuple(f.shape[-1] for f in ours) == enc.num_ch_enc
    for k, (o, r) in enumerate(zip(ours, ref)):
        assert o.shape == r.shape, k
        _close(o, r, what=f"feature {k}")
    # the bridge is the inverse of JAX's importer of reference weights
    back = jti.import_mobilenetv2_encoder(
        {k: v.numpy() for k, v in sd.items()}, use_last_layer)
    flat = jax.tree_util.tree_leaves_with_path(ev)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, v in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, v, err_msg=str(path))


def test_kitti_mobilenet_forward_through_factory(image):
    """encoder_type=mobilenet in the KITTI factory: MobileNetV2 + the KITTI
    wavelet decoder, against JAX's pair on the same weights."""
    opts = SimpleNamespace(encoder_type="mobilenet", num_layers=18,
                           use_wavelets=True)
    enc, ch = factory.make_depth_encoder(opts)
    jenc, jch = jfactory.make_depth_encoder(opts)
    assert ch == jch == (32, 24, 32, 64, 1280)
    x = jnp.asarray(image)
    ev = random_vars(jenc.init, x[:1], seed=3)
    jfeats = jenc.apply(ev, x)
    jdecoder = JKitti(num_ch_enc=ch)
    dv = random_vars(jdecoder.init, jfeats, seed=4)
    ref = jax.jit(lambda e, d, im: jdecoder.apply(d, jenc.apply(e, im)))(
        ev, dv, x)
    enc_sd, dec_sd = ti.state_dicts_from_jax(ev, dv)
    dec = KittiWaveletDecoder(ch)
    ti.load_state_dicts(enc, dec, enc_sd, dec_sd)
    with torch.no_grad():
        out = dec.eval()(enc.eval()(torch.from_numpy(image)))
    for s in range(4):
        _close(out[("disp", s)].numpy(), ref[("disp", s)], what=s)


# --- decoders ----------------------------------------------------------------

@pytest.fixture(scope="module")
def features():
    rng = np.random.RandomState(5)
    return [rng.randn(N, H // 2 ** (i + 1), W // 2 ** (i + 1), c)
            .astype(np.float32) for i, c in enumerate(CH)]


DECODERS = {
    "decoder": ("NyuDecoder", {}),
    "decoder_dw": ("NyuDecoder", {"is_depthwise": True}),
    "decoder224": ("NyuDecoder224", {}),
    "decoder224_dw": ("NyuDecoder224", {"is_depthwise": True}),
    "wave": ("NyuDecoderWave", {}),
    "wave_dw_waveconv": ("NyuDecoderWave", {"dw_waveconv": True}),
    "wave_dw_upconv": ("NyuDecoderWave", {"dw_upconv": True}),
    "wave224": ("NyuDecoderWave224", {}),
    "wave224_dw": ("NyuDecoderWave224", {"dw_waveconv": True,
                                         "dw_upconv": True}),
}


def decoder_pair(name, features, seed=6, head_scale=None):
    """(JAX module, its numpy variables, the port module on them)."""
    cls, kw = DECODERS[name]
    jd = getattr(jdec, cls)(num_ch_enc=CH, **kw)
    dv = random_vars(jd.init, [jnp.asarray(f) for f in features], seed=seed)
    if head_scale is not None:
        # quieter high-frequency heads: a mask of partial density at 0.05
        for k in ("wave1", "wave2", "wave3"):
            dv["params"][k]["kernel"] *= head_scale
    td = getattr(tdec, cls)(CH, **kw)
    _load(td, ti.state_dicts_from_jax(None, dv)[1])
    return jd, dv, td


def _port_out(td, features, **kw):
    with torch.no_grad():
        return td([torch.from_numpy(f) for f in features], **kw)


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_dense_equals_jax(features, name):
    jd, dv, td = decoder_pair(name, features)
    ref = jd.apply(dv, [jnp.asarray(f) for f in features])
    ours = _port_out(td, features)
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        _close(ours[k].numpy(), ref[k], what=k)


def test_wave_decoder_bridge_equals_jax_exporter(features):
    _, dv, td = decoder_pair("wave", features)
    ours = ti.state_dicts_from_jax(None, dv)[1]
    ref = jti.export_nyu_wave_decoder(dv)
    assert [f"decoder.{k}" for k in ours] == list(ref)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[f"decoder.{k}"])
    assert set(ours) == set(td.state_dict())


@pytest.fixture(scope="module")
def sparse_wave(features):
    jd, dv, td = decoder_pair("wave", features, head_scale=0.05)
    jf = [jnp.asarray(f) for f in features]
    ref = {b: jd.apply(dv, jf, thresh_ratio=0.05, use_pallas=b)
           for b in BACKENDS}
    ours = {b: _port_out(td, features, thresh_ratio=0.05, use_pallas=b)
            for b in BACKENDS}
    return ref, ours, td


@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_backend_equals_jax_and_xla(sparse_wave, backend):
    ref, ours, _ = sparse_wave
    for s in (0, 1):
        d = float(ours[False][("wavelet_mask", s)].mean())
        assert 0.0 < d < 1.0, (s, d)
    out = ours[backend]
    assert set(out) == set(ref[backend])
    for k, r in ref[backend].items():
        if k[0] in ("wavelet_mask", "total_ops"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(r),
                                          err_msg=str(k))
            assert torch.equal(out[k], ours[False][k]), k
        else:
            _close(out[k].numpy(), r, atol=1e-5, what=k)
            _close(out[k].numpy(), ours[False][k].numpy(), atol=1e-5,
                   what=k)


def test_sparse_thresh_minus1_equals_dense_bitwise(features):
    _, _, td = decoder_pair("wave", features)
    dense = _port_out(td, features)
    sparse = _port_out(td, features, thresh_ratio=-1)
    for k, v in dense.items():
        assert torch.equal(sparse[k], v), k


@pytest.mark.parametrize("backend", [False, "pallas2d"])
def test_batched_sparse_equals_batch1(sparse_wave, features, backend):
    _, ours, td = sparse_wave
    for i in range(N):
        one = _port_out(td, [f[i:i + 1] for f in features],
                        thresh_ratio=0.05, use_pallas=backend)
        for k, v in one.items():
            b = ours[backend][k][i:i + 1]
            if k[0] in ("wavelet_mask", "total_ops"):
                assert torch.equal(b, v), k
            else:
                _close(b.numpy(), v.numpy(), what=k)


def test_bf16_backends_reaching_the_kernel_raise(features):
    """bfloat16 (a full cast): pallas, pallas2d and capacity reach K1 / K4
    (capacity through the wave heads), which JAX cannot lower in bf16
    either; xla runs, and depthwise heads and convs reach no kernel."""
    jd, dv, td = decoder_pair("wave", features)
    jb = [jnp.asarray(f).astype(jnp.bfloat16) for f in features]
    with pytest.raises(ValueError, match="mismatched return types"):
        jd.apply(jcast(dv, jnp.bfloat16), jb, thresh_ratio=0.05,
                 use_pallas="capacity")
    cast_floats(td, torch.bfloat16)
    tb = [torch.from_numpy(f).to(torch.bfloat16) for f in features]
    for backend in (True, "pallas2d", "capacity"):
        with pytest.raises(NotImplementedError, match="float32 only"):
            td(tb, thresh_ratio=0.05, use_pallas=backend)
    assert td(tb, thresh_ratio=0.05)[("disp", 0)].dtype == torch.bfloat16
    dw = tdec.NyuDecoderWave(CH, dw_waveconv=True, dw_upconv=True).eval()
    cast_floats(dw, torch.bfloat16)
    assert not dw.reaches_kernel(True)
    with torch.no_grad():
        dw(tb, thresh_ratio=0.05, use_pallas=True)


def test_factory_and_options_match_jax(features):
    import dataclasses

    from wavelet_monodepth_tpu.utils.config import NyuOptions as JOptions
    from wavelet_monodepth_tpu.utils.config import parse_nyu_args as jparse
    from wavelet_monodepth_tpu_torch.utils.config import (NyuOptions,
                                                          parse_nyu_args)
    jf = {f.name: f.default for f in dataclasses.fields(JOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(NyuOptions)}
    assert set(tf) - set(jf) == {"device"} and tf["device"] == "cuda"
    assert {k: tf[k] for k in jf} == jf
    argv = ["--encoder_type", "mobilenet_light", "--use_wavelets",
            "--loss_scales", "0", "1", "--no-pretrained_encoder"]
    j, t = jparse(argv), parse_nyu_args(argv)
    assert {k: getattr(t, k) for k in jf} == dataclasses.asdict(j)
    for enc_type in ("densenet", "resnet", "mobilenet", "mobilenet_light"):
        for wave, use_224, dw in ((True, False, False), (True, True, True),
                                  (False, False, True), (False, True, False)):
            opts = NyuOptions(encoder_type=enc_type, num_layers=18,
                              use_wavelets=wave, use_224=use_224,
                              dw_waveconv=dw)
            enc, ch = factory.make_nyu_encoder(opts)
            jenc, jch = jfactory.make_nyu_encoder(opts)
            assert ch == jch and type(enc).__name__ == type(jenc).__name__
            dec = factory.make_nyu_decoder(ch, opts)
            assert type(dec).__name__ == \
                type(jfactory.make_nyu_decoder(jch, opts)).__name__
    with pytest.raises(NotImplementedError):
        factory.make_nyu_decoder(CH, NyuOptions(use_wavelets=True,
                                                use_sparse=True,
                                                use_224=True))
    # use_polyphase, which raised before the fold was ported, now runs:
    # the dense decode equals JAX's with the flag (1e-4 as the dense parity
    # above; tests/test_torch_port_polyphase.py covers the rest)
    jd, dv, _ = decoder_pair("wave", features)
    folded = _load(tdec.NyuDecoderWave(CH, use_polyphase=True),
                   ti.state_dicts_from_jax(None, dv)[1])
    ref = jdec.NyuDecoderWave(num_ch_enc=CH, use_polyphase=True).apply(
        dv, [jnp.asarray(f) for f in features])
    ours = _port_out(folded, features)
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k].numpy(), ref[k], what=k)
