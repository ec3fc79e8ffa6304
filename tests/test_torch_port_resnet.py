"""Port parity, the deep ResNet encoders: ResNet34 (BasicBlocks) and
ResNet50 (Bottlenecks, the stride on the 3x3) of
wavelet_monodepth_tpu_torch against the JAX encoder at 64x96, with the
weights crossed both ways through the reference's state-dict names.

Tolerances: features 1e-4 (the JAX encoder folds its input normalisation
into the stem BN, the port does not: equal up to f32 reassociation);
the state dicts key for key and bit for bit.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu_torch.models import factory
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.layers import init_params
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.models.resnet import num_ch_enc
from wavelet_monodepth_tpu_torch.tools import infer as tinfer
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
H, W, N = 64, 96, 2


def _bn_perturbed(variables, seed):
    """numpy copy of flax encoder variables with non-trivial BN affines
    and running statistics, so every BN field crosses the bridge."""
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(np.array, variables)

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
    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module", params=[34, 50])
def jax_encoder(request):
    depth = request.param
    img = np.random.RandomState(depth).rand(N, H, W, 3).astype(np.float32)
    enc = JEncoder(num_layers=depth)
    ev = _bn_perturbed(enc.init(jax.random.PRNGKey(depth),
                                jnp.asarray(img[:1])), depth)
    feats = [np.asarray(f) for f in enc.apply(ev, jnp.asarray(img))]
    return {"depth": depth, "img": img, "enc": enc, "ev": ev,
            "feats": feats}


def _port_features(enc, img):
    with torch.no_grad():
        return [f.numpy() for f in enc(torch.from_numpy(img))]


def test_num_ch_enc_and_depths_equal_jax():
    for depth in (18, 34, 50, 101, 152):
        assert num_ch_enc(depth) == j_num_ch_enc(depth)
        opts = SimpleNamespace(encoder_type="resnet", num_layers=depth)
        enc, ch = factory.make_depth_encoder(opts)
        assert ch == j_num_ch_enc(depth) == enc.num_ch_enc
        blocks = tuple(len(getattr(enc.encoder, f"layer{i}"))
                       for i in (1, 2, 3, 4))
        assert blocks == jti._RESNET_BLOCKS[depth]
    with pytest.raises(ValueError, match="num_layers"):
        ResnetEncoder(20)


def test_bridge_equals_jax_exporter_key_for_key(jax_encoder):
    ev, depth = jax_encoder["ev"], jax_encoder["depth"]
    ours = ti.state_dicts_from_jax(ev, None)[0]
    ref = jti.export_resnet_encoder(ev, num_layers=depth)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    if depth == 50:
        assert "encoder.layer1.0.conv3.weight" in ours
        assert "encoder.layer4.0.downsample.1.running_var" in ours
        assert ours["encoder.layer2.0.conv2.weight"].shape == (128, 128, 3, 3)


def test_features_equal_jax_on_jax_weights(jax_encoder):
    """JAX weights -> the port (strict load) -> the same five features."""
    depth = jax_encoder["depth"]
    enc = ResnetEncoder(depth).eval()
    dec = KittiWaveletDecoder(enc.num_ch_enc)
    report = ti.load_state_dicts(
        enc, dec, ti.state_dicts_from_jax(jax_encoder["ev"], None)[0],
        dec.state_dict())
    assert report["dropped"] == []
    ours = _port_features(enc, jax_encoder["img"])
    assert [f.shape[-1] for f in ours] == list(j_num_ch_enc(depth))
    for k, (o, r) in enumerate(zip(ours, jax_encoder["feats"])):
        assert o.shape == r.shape, k
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-5,
                                   err_msg=f"feature {k}")


def test_features_equal_jax_on_port_weights(jax_encoder, tmp_path):
    """Seeded port weights, written as a reference folder, read by JAX's
    importer: the JAX encoder gives the port's features."""
    depth = jax_encoder["depth"]
    g = torch.Generator().manual_seed(depth)
    enc = init_params(ResnetEncoder(depth), g).eval()
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), g)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(1 + 0.2 * torch.rand(c, generator=g))
    ti.save_reference_checkpoint(str(tmp_path), enc, dec, H, W)
    sd = jti.load_pth(os.path.join(tmp_path, "encoder.pth"))
    jv = jti.import_resnet_encoder(sd, depth)
    ref = jax_encoder["enc"].apply(jv, jnp.asarray(jax_encoder["img"]))
    for k, (o, r) in enumerate(zip(_port_features(enc, jax_encoder["img"]),
                                   ref)):
        np.testing.assert_allclose(o, np.asarray(r), atol=1e-4, rtol=1e-5,
                                   err_msg=f"feature {k}")


def test_resnet50_reference_folder_from_jax_exporter_serves(tmp_path):
    """JAX's exporter writes a ResNet50 folder; the port's load_model reads
    it with strict=True and serves it."""
    enc = JEncoder(num_layers=50)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    ev = jax.tree_util.tree_map(np.asarray,
                                enc.init(jax.random.PRNGKey(5), x))
    tenc = ResnetEncoder(50)
    dec_sd = KittiWaveletDecoder(tenc.num_ch_enc).state_dict()
    enc_sd = {k: torch.as_tensor(np.array(v)) for k, v in
              jti.export_resnet_encoder(ev, num_layers=50).items()}
    enc_sd.update(height=H, width=W, use_stereo=True)
    torch.save(enc_sd, os.path.join(tmp_path, "encoder.pth"))
    torch.save(dec_sd, os.path.join(tmp_path, "depth.pth"))
    args = tinfer.parse_args(["--image_path", str(tmp_path),
                              "--torch_model_path", str(tmp_path),
                              "--num_layers", "50"])
    forward, feed = tinfer.load_model(args, "cpu")
    assert feed == (H, W)
    out = forward(torch.zeros(1, H, W, 3), None)
    assert out[("disp", 0)].shape == (1, H, W, 1)
    assert bool(torch.isfinite(out[("disp", 0)]).all())
