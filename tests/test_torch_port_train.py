"""Port parity, the KITTI train step: wavelet_monodepth_tpu_torch's
KittiTrainSetup against the JAX package's on the same weights (crossed by
tools/torch_import.py), the same uint8 batch and JAX's automask noise, at
64x96, batch 2, with the banded warp "on" (its plain version vs the
Pallas kernel in interpret mode) and "off" (F.grid_sample vs the gather).

Tolerances, each with its reason:
  * losses: 1e-5 relative (float32 sums in another order);
  * gradients: at this size the float32 gradient itself is far from exact
    (the port's float32 gradients lie 0.2-3.5% from its float64 ones in
    norm: SSIM's variance cancellation, BN over 12-48 values per channel).
    So each tensor of JAX's float32 gradient must lie within 3x the port's
    own float32 error (plus 1e-6) of the port's float64 gradient: a port
    whose function differed from JAX's would miss by the difference;
  * Adam's first step moves each element by lr g / (|g| + eps), g the
    gradient plus weight decay: wherever
    |g| exceeds 10x the two float32 gradients' largest disagreement d in
    its tensor (elsewhere the sign is float noise), the two updates agree
    within lr eps d / g^2 (the most d can move them) + 1e-5 lr + 2 ulp of
    the parameter (float32 arithmetic and storage); and no
    update larger than lr (1 + 1e-4) plus the parameter's float32 rounding;
  * BN running statistics: 1e-5 relative (the biased variance, as flax).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavelet_monodepth_tpu.ops import augment as jaug
from wavelet_monodepth_tpu.train import optim as joptim
from wavelet_monodepth_tpu.train.kitti import KittiTrainSetup as JSetup
from wavelet_monodepth_tpu.utils.config import KittiOptions as JOptions
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.train import optim as toptim
from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup as TSetup
from wavelet_monodepth_tpu_torch.utils import config as tconfig
from wavelet_monodepth_tpu_torch.utils.config import KittiOptions as TOptions

torch.set_num_threads(1)
H, W, N = 64, 96, 2
LR = 1e-4
FIELDS = dict(use_stereo=True, frame_ids=(0,), use_depth_hints=True,
              use_wavelets=True, height=H, width=W, batch_size=N,
              weights_init="scratch", learning_rate=LR)


def _batch(seed=0):
    """uint8 stereo feed (the device-augment contract of data/kitti.py):
    a textured left view, the right view shifted 2-4 px, jitter factors,
    intrinsics per scale, +-0.1 baselines, hints with holes."""
    rs = np.random.RandomState(seed)
    tex = rs.rand(H, W + 8, 3)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    left = np.stack([tex[:, :W], tex[:, 2:W + 2]])
    right = np.stack([tex[:, 4:W + 4], tex[:, 0:W]])
    batch = {}
    for s in range(4):
        h, w = H // 2 ** s, W // 2 ** s
        small = left.reshape(N, h, 2 ** s, w, 2 ** s, 3).mean(axis=(2, 4))
        batch[("color_u8", "0", s)] = (small * 255).astype(np.uint8)
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
        batch[("K", s)] = np.repeat(k[None], N, 0)
        batch[("inv_K", s)] = np.linalg.pinv(batch[("K", s)]).astype(
            np.float32)
    batch[("color_u8", "s", 0)] = (right * 255).astype(np.uint8)
    batch[("jitter",)] = np.array([[1.1, 0.9, 1.15, 0.05],
                                   [1.0, 1.0, 1.0, 0.0]], np.float32)
    t = np.repeat(np.eye(4, dtype=np.float32)[None], N, 0)
    t[:, 0, 3] = (-0.1, 0.1)
    batch[("stereo_T",)] = t
    depth = np.full((N, H, W, 1), 0.58 * W * 0.1 / 4.0, np.float32)
    depth *= (1.0 + 0.2 * rs.rand(N, H, W, 1)).astype(np.float32)
    depth[:, ::9, ::7] = 0.0
    # no hints in the 8 border columns: there the predicted-depth warp and
    # the hint warp both clamp to the same border pixel, reproj and
    # hint-reproj tie exactly, and the argmin would follow float rounding
    depth[:, :, :8] = 0.0
    depth[:, :, -8:] = 0.0
    batch[("depth_hint",)] = depth
    batch[("depth_hint_mask",)] = (depth > 0).astype(np.float32)
    return batch


def _jax_noise(rng, shape):
    out = {}
    for s in range(4):
        rng, sub = jax.random.split(rng)
        out[s] = torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32)))
    return out


def _conditioned(jstate):
    """The JAX init with the wavelet heads' 3x3 convs scaled by 0.1, so
    yh stays small and no disparity reaches the clamp at 0: there
    depth = 1 / (0.01 + 9.99 disp) turns float32 rounding of disp into
    1e5-fold larger depth gradients, and a few such pixels would decide
    every gradient's rounding error."""
    depth = dict(jstate.params["depth"])
    for name, node in depth.items():
        if "_pos" in name or "_neg" in name:
            conv = {k: v * 0.1 for k, v in node["conv"].items()}
            depth[name] = dict(node, conv=conv)
    return jstate.replace(params=dict(jstate.params, depth=depth))


def _cross_weights(jstate, tstate):
    p, bs = jstate.params, jstate.batch_stats
    enc_sd, dec_sd = ti.state_dicts_from_jax(
        {"params": p["encoder"], "batch_stats": bs["encoder"]},
        {"params": p["depth"]})
    ti.load_state_dicts(tstate.encoder, tstate.decoder, enc_sd, dec_sd)


def _float64_grads(tsetup, jstate, batch, noise):
    """The port's gradient of the same step in float64."""
    from wavelet_monodepth_tpu_torch.ops import augment as taug
    state = tsetup.init_state()
    _cross_weights(jstate, state)
    state.encoder.double()
    state.decoder.double()
    ins = {k: v.double() if v.is_floating_point() else v
           for k, v in taug.expand_batch(batch).items()}
    _, losses = tsetup.forward(state, ins, {k: v.double() for k, v in
                                            noise.items()}, train=True)
    losses["loss"].backward()
    return _named(state, "grad")


def _named(tstate, attr=None):
    out = {}
    for prefix, m in (("encoder", tstate.encoder), ("depth", tstate.decoder)):
        for name, prm in m.named_parameters():
            v = prm if attr is None else getattr(prm, attr)
            out[f"{prefix}.{name}"] = v.detach().numpy().copy()
    return out


@pytest.fixture(scope="module", params=["on", "off"])
def one_step(request):
    """Both frameworks' first train step of one configuration."""
    kern = request.param
    jsetup = JSetup(JOptions(**FIELDS, stereo_warp_kernel=kern),
                    steps_per_epoch=10)
    jstate = _conditioned(jsetup.init_state(jax.random.PRNGKey(0)))
    batch = _batch()
    rng = jax.random.PRNGKey(7)

    def loss_fn(params, stats, inputs, r):
        inputs = jaug.expand_batch(inputs, jnp)
        _, losses, new_stats = jsetup.forward(params, stats, inputs, r,
                                              train=True)
        return losses["loss"], (losses, new_stats)

    @jax.jit
    def ref_step(params, stats, opt_state, inputs, r):
        grads, (losses, new_stats) = jax.grad(loss_fn, has_aux=True)(
            params, stats, inputs, r)
        updates, _ = jsetup.optimizer.update(grads, opt_state, params)
        return grads, losses, new_stats, optax.apply_updates(params, updates)

    grads, losses, new_stats, new_params = jax.device_get(ref_step(
        jstate.params, jstate.batch_stats, jstate.opt_state,
        {k: jnp.asarray(v) for k, v in batch.items()}, rng))

    tsetup = TSetup(TOptions(**FIELDS, stereo_warp_kernel=kern,
                             device="cpu"), steps_per_epoch=10)
    tstate = tsetup.init_state()
    _cross_weights(jstate, tstate)
    before = _named(tstate)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    noise = _jax_noise(rng, (N, H, W, 1))
    tlosses = tsetup.train_step(tstate, tbatch, noise)
    return dict(jlosses=losses, tlosses=tlosses,
                g64=_float64_grads(tsetup, jstate, tbatch, noise),
                jgrads=ti.param_trees_from_jax(grads["encoder"],
                                               grads["depth"]),
                tgrads=_named(tstate, "grad"), before=before,
                jparams=ti.param_trees_from_jax(new_params["encoder"],
                                                new_params["depth"]),
                tparams=_named(tstate),
                jstats=ti.state_dicts_from_jax(
                    {"params": new_params["encoder"],
                     "batch_stats": new_stats["encoder"]},
                    {"params": new_params["depth"]})[0],
                tstats={k: v.numpy() for k, v in
                        tstate.encoder.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))},
                tstate=tstate)


def test_losses_match_jax(one_step):
    j, t = one_step["jlosses"], one_step["tlosses"]
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-5,
                                   err_msg=k)


def test_every_gradient_matches_jax(one_step):
    j, t, g64 = one_step["jgrads"], one_step["tgrads"], one_step["g64"]
    assert set(j) == set(t) == set(g64) and len(j) == 112
    for k in j:
        ref = j[k].numpy()
        scale = np.linalg.norm(g64[k])
        e_port = np.linalg.norm(t[k] - g64[k])
        e_jax = np.linalg.norm(ref - g64[k])
        assert e_jax <= 3 * e_port + 1e-6 * scale, (k, e_jax, e_port, scale)


def test_params_after_adam_step_match_jax(one_step):
    n_decided = n_all = 0
    for k, ref in one_step["jparams"].items():
        ref = ref.numpy()
        # the decayed gradient Adam sees (decoder biases do not decay)
        wd = 0.0 if k.startswith("depth.") and k.endswith("bias") else 1e-5
        g = one_step["jgrads"][k].numpy() + wd * one_step["before"][k]
        step_t = one_step["tparams"][k] - one_step["before"][k]
        step_j = ref - one_step["before"][k]
        ulp = np.spacing(np.abs(one_step["before"][k]).max())
        assert np.abs(step_t).max() <= LR * (1 + 1e-4) + 2 * ulp, k
        noise = np.abs(one_step["tgrads"][k] - one_step["jgrads"][k]
                       .numpy()).max()
        decided = np.abs(g) > 10 * noise
        n_decided += decided.sum()
        n_all += decided.size
        # step = lr g / (|g| + eps): a gradient error d moves it by at
        # most lr eps d / g^2; then the two Adams' float32 arithmetic
        # (1e-5 lr) and the rounding of p + step to float32 (2 ulp of p)
        tol = (LR * 1e-8 * noise / g[decided] ** 2 + 1e-5 * LR
               + 2 * np.spacing(np.abs(one_step["before"][k][decided])))
        assert (np.abs(step_t - step_j)[decided] <= tol).all(), k
    assert n_decided > 0.3 * n_all, (n_decided, n_all)   # ~43% here


def test_bn_running_stats_biased_variance(one_step):
    j, t = one_step["jstats"], one_step["tstats"]
    assert len(t) == 2 * 20
    for k, v in t.items():
        np.testing.assert_allclose(v, j[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_steplr_and_decay_groups():
    sched_j = joptim.steplr_schedule(LR, 7, 15)
    sched_t = toptim.steplr(LR, 7, 15)
    for count in range(0, 7 * 40, 3):
        assert sched_t(count) == pytest.approx(float(sched_j(count)),
                                               rel=1e-12)
    jsetup = JSetup(JOptions(**FIELDS), steps_per_epoch=7)
    params = jsetup.init_state(jax.random.PRNGKey(0)).params
    mask = joptim._decay_mask(params)
    masked = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32), mask, params)
    jmask = {k: bool(v.numpy().all())
             for k, v in ti.param_trees_from_jax(masked["encoder"],
                                                 masked["depth"]).items()}
    tstate = TSetup(TOptions(**FIELDS, device="cpu")).init_state()
    decay, no_decay = toptim.decay_groups(tstate.encoder, tstate.decoder)
    ids = {id(p): True for p in decay}
    ids.update({id(p): False for p in no_decay})
    named = {f"{pre}.{n}": p for pre, m in (("encoder", tstate.encoder),
                                            ("depth", tstate.decoder))
             for n, p in m.named_parameters()}
    assert {k: ids[id(p)] for k, p in named.items()} == jmask
    groups = tstate.optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [1e-5, 0.0]
    assert groups[0]["betas"] == (0.9, 0.999) and groups[0]["eps"] == 1e-8


def test_options_flag_for_flag():
    jf = {f.name: f.default for f in dataclasses.fields(JOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(TOptions)}
    assert set(tf) - set(jf) == {"device"}
    assert {k: tf[k] for k in jf} == jf
    argv = ["--use_stereo", "--frame_ids", "0", "--scales", "0", "1",
            "--no-png", "--batch_size", "4", "--stereo_warp_kernel", "on"]
    from wavelet_monodepth_tpu.utils.config import parse_kitti_args
    j, t = parse_kitti_args(argv), tconfig.parse_kitti_args(argv)
    assert {k: getattr(t, k) for k in jf} == dataclasses.asdict(j)
    assert t.all_frame_ids == (0, "s") and not t.use_pose_net


def _baseline_polyphase():
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
        DepthDecoder
    DepthDecoder((64, 64, 128, 256, 512), use_polyphase=True)


@pytest.mark.parametrize("kw,match", [
    (dict(native_decode=True), "native_decode"),
    (dict(frame_ids=(0, -1, 1), pose_model_type="shared"), "'shared'"),
    (dict(encoder_type="mobilenet", weights_init="pretrained",
          imagenet_weights_path="resnet18.pth"), "MobileNetV2"),
    (_baseline_polyphase, "use_polyphase")])
def test_unported_features_raise(kw, match):
    """What the port does not run raises: the options JAX cannot run
    either ("shared" pose nets, MobileNetV2's ImageNet start) and the
    TPU-only polyphase upconv. (Data parallelism is ported:
    tests/test_torch_port_ddp.py.)"""
    with pytest.raises(NotImplementedError, match=match):
        if callable(kw):
            kw()
        else:
            TSetup(TOptions(**dict(FIELDS, **kw), device="cpu")).init_state()


def test_setup_follows_opts_device():
    """Without device=, the setup runs where opts.device says: the card by
    default, which raises the plain no-card error on a machine without
    one."""
    assert TSetup(TOptions(**FIELDS, device="cpu")).device == \
        torch.device("cpu")
    assert TOptions(**FIELDS).device == "cuda"
    if torch.cuda.is_available():
        assert TSetup(TOptions(**FIELDS)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card is visible"):
            TSetup(TOptions(**FIELDS))


def test_hint_supervised_loss_decreases():
    """Twin of tests/test_training_learns.py: overfitting one batch, the
    port's hint loss falls by >= 15% in 30 steps."""
    import cv2
    rng = np.random.RandomState(0)
    tex = rng.rand(H, W * 2, 3).astype(np.float32)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    left, right = tex[:, :W], tex[:, 4:4 + W]
    inputs = {}
    for s in range(4):
        h, w = H // 2 ** s, W // 2 ** s
        for fid, img in (("0", left), ("s", right)):
            im = torch.from_numpy(cv2.resize(img, (w, h)))[None]
            inputs[("color", fid, s)] = im
            inputs[("color_aug", fid, s)] = im
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
        inputs[("K", s)] = torch.from_numpy(k)[None]
        inputs[("inv_K", s)] = torch.linalg.inv(inputs[("K", s)])
    t = torch.eye(4)[None]
    t[0, 0, 3] = -0.1
    inputs[("stereo_T",)] = t
    inputs[("depth_hint",)] = torch.full((1, H, W, 1), 0.58 * W * 0.1 / 4.0)
    inputs[("depth_hint_mask",)] = torch.ones(1, H, W, 1)
    setup = TSetup(TOptions(**dict(FIELDS, batch_size=1), device="cpu"))
    state = setup.init_state()
    noise = torch.Generator().manual_seed(0)
    hints = []
    for _ in range(30):
        losses = setup.train_step(state, inputs, noise)
        assert torch.isfinite(losses["loss"])
        hints.append(float(losses["depth_hint_loss/0"]))
    assert hints[-1] < 0.85 * hints[0], hints


def test_checkpoint_roundtrip_serves_with_infer(tmp_path):
    """save_checkpoint writes the reference layout; latest_checkpoint
    finds it; load_checkpoint restores it; tools/infer loads it."""
    from wavelet_monodepth_tpu_torch.tools import infer
    from wavelet_monodepth_tpu_torch.utils import checkpoint as ckpt
    opts = TOptions(**FIELDS, device="cpu")
    setup = TSetup(opts)
    state = setup.init_state()
    log = str(tmp_path / "log")
    assert ckpt.latest_checkpoint(log) is None
    for epoch in (0, 1):
        folder = ckpt.save_checkpoint(log, epoch, state, opts)
    os.remove(os.path.join(folder, "adam.pth"))        # a cut-off save
    assert ckpt.latest_checkpoint(log).endswith("weights_0")
    assert sorted(os.listdir(tmp_path / "log" / "models")) == [
        "opt.json", "weights_0", "weights_1"]
    fresh = TSetup(opts).init_state(torch.Generator().manual_seed(5))
    meta = ckpt.load_checkpoint(os.path.join(log, "models", "weights_0"),
                                fresh)
    assert meta == {"height": H, "width": W, "use_stereo": 1}
    for a, b in zip(state.decoder.parameters(), fresh.decoder.parameters()):
        assert torch.equal(a, b)
    args = infer.parse_args(["--image_path", ".", "--torch_model_path",
                             os.path.join(log, "models", "weights_0")])
    forward, feed = infer.load_model(args, "cpu")
    assert feed == (H, W)
    out = forward(torch.rand(1, H, W, 3), None)
    assert out[("disp", 0)].shape == (1, H, W, 1)
    assert tconfig.load_opts(TOptions, os.path.join(
        log, "models", "opt.json")) == opts
