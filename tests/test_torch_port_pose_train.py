"""Port parity, KITTI training with pose networks, the baseline decoder
and MobileNetV2: wavelet_monodepth_tpu_torch's KittiTrainSetup against
the JAX package's forward and gradient on the same weights (the port's
seeded init, read into JAX by its own importers in
wavelet_monodepth_tpu/tools/torch_import.py; the port's bridge names
JAX's gradients back), the same uint8 batch (frames 0, -1, 1 and s) and
JAX's automask noise, at 64x96, batch 2; then tools/train_kitti.main on
M+S and on the odometry layout, with tools/evaluate_pose.main on its
checkpoint.

Configurations: M+S + depth hints with the separate_resnet pose net in
"pairs" mode ("ms") and monocular PoseCNN in "all" mode ("cnn_all"),
each held step for step (losses, every gradient, the BN statistics of
both encoders); monocular PoseCNN "pairs", the baseline DepthDecoder and
MobileNetV2 from scratch, their first step's losses; the bf16
mixed-precision M+S step.

The full configurations run JAX's step in float64 (x64 on) against the
port's float64 gradient. With temporal frames, the min over the
reprojections of -1, 1 (and s) routes each pixel's gradient to one
frame, and at a near tie float32 rounding picks the frame: here a few of
the 49k pixels route differently in JAX's float32 run and the port's,
which moves whole tensors' float32 gradients by more than their float32
error. In float64 no tie is that close. JAX's gather warp computes its
sample coordinates and weights in float32 whatever the dtype
(`ops/image.py::_bilinear_gather`, pinned for bfloat16), so in float64
its warped images still carry float32 rounding (up to 1.4e-6 here).

Tolerances, each with its reason:
  * losses: the port's float32 step within 1e-4 relative of JAX's
    float64 losses (float32 rounding; the automask's 1e-5 noise is drawn
    in each dtype, and an argmin may flip at a near tie); float64 within
    1e-7 relative (JAX's float32 sample weights: 1.3e-8 at most here);
  * gradients: JAX's float64 gradient within 5e-5 of each tensor's norm
    (plus 1e-12 of the largest) of the port's float64 gradient (the
    float32 sample weights again: 1.2e-5 at most here, on a wavelet
    head's bias; a wrong pose, frame order or warp moves them by O(1));
  * BN running statistics of the port's float32 step: 1e-5 relative,
    1e-6 absolute of JAX's float64 ones;
  * the other configurations' first step: 1e-4 relative of JAX's
    float32 losses;
  * bf16: tests/test_torch_port_bf16.py's bounds (losses within 1e-2
    relative of JAX's mixed-precision forward; float32 states).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.ops import augment as jaug
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.train import optim as joptim
from wavelet_monodepth_tpu.train.kitti import KittiTrainSetup as JSetup
from wavelet_monodepth_tpu.utils.config import KittiOptions as JOptions
from wavelet_monodepth_tpu.utils.precision import cast_floats as jcast
from wavelet_monodepth_tpu_torch.ops import augment as taug
from wavelet_monodepth_tpu_torch.tools import evaluate_pose as tevp
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.tools import train_kitti
from wavelet_monodepth_tpu_torch.train import optim as toptim
from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup as TSetup
from wavelet_monodepth_tpu_torch.utils import checkpoint as ckpt
from wavelet_monodepth_tpu_torch.utils.config import KittiOptions as TOptions

torch.set_num_threads(1)
H, W, N = 64, 96, 2
LR = 1e-4
BASE = dict(height=H, width=W, batch_size=N, weights_init="scratch",
            learning_rate=LR, stereo_warp_kernel="off")
CONFIGS = {
    "ms": dict(use_stereo=True, frame_ids=(0, -1, 1), use_depth_hints=True,
               use_wavelets=True),
    "cnn_all": dict(frame_ids=(0, -1, 1), use_wavelets=True,
                    pose_model_type="posecnn", pose_model_input="all"),
    "cnn_pairs": dict(frame_ids=(0, -1, 1), use_wavelets=True,
                      pose_model_type="posecnn"),
    "baseline": dict(use_stereo=True, frame_ids=(0,), use_depth_hints=True),
    "mobilenet": dict(use_stereo=True, frame_ids=(0,), use_depth_hints=True,
                      use_wavelets=True, encoder_type="mobilenet"),
}


def _batch(fields, seed=0):
    """uint8 feed of data/kitti.py's device-augment contract: a textured
    frame 0, frames -1 / 1 shifted 1-3 px, the right view shifted 2-4 px,
    jitter factors, intrinsics per scale, +-0.1 baselines, and hints
    with holes and none in the 8 border columns (there the predicted and
    the hint warps clamp to the same pixel and tie exactly)."""
    rs = np.random.RandomState(seed)
    tex = rs.rand(H + 8, W + 8, 3)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0

    def view(dy, dx):
        return np.stack([tex[4 + dy:4 + dy + H, 4 + dx:4 + dx + W],
                         tex[4 - dy:4 - dy + H, 4 - dx:4 - dx + W]])
    u8 = {"0": view(0, 0), "-1": view(1, -2), "1": view(-1, 3),
          "s": view(0, 4)}
    frames = [str(f) for f in JOptions(**fields).all_frame_ids]
    batch = {}
    for s in range(4):
        h, w = H // 2 ** s, W // 2 ** s
        small = u8["0"].reshape(N, h, 2 ** s, w, 2 ** s, 3).mean(axis=(2, 4))
        batch[("color_u8", "0", s)] = (small * 255).astype(np.uint8)
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
        batch[("K", s)] = np.repeat(k[None], N, 0)
        batch[("inv_K", s)] = np.linalg.pinv(batch[("K", s)]).astype(
            np.float32)
    for f in frames[1:]:
        batch[("color_u8", f, 0)] = (u8[f] * 255).astype(np.uint8)
    batch[("jitter",)] = np.array([[1.1, 0.9, 1.15, 0.05],
                                   [1.0, 1.0, 1.0, 0.0]], np.float32)
    if "s" in frames:
        t = np.repeat(np.eye(4, dtype=np.float32)[None], N, 0)
        t[:, 0, 3] = (-0.1, 0.1)
        batch[("stereo_T",)] = t
    if fields.get("use_depth_hints"):
        depth = np.full((N, H, W, 1), 0.58 * W * 0.1 / 4.0, np.float32)
        depth *= (1.0 + 0.2 * rs.rand(N, H, W, 1)).astype(np.float32)
        depth[:, ::9, ::7] = 0.0
        depth[:, :, :8] = 0.0
        depth[:, :, -8:] = 0.0
        batch[("depth_hint",)] = depth
        batch[("depth_hint_mask",)] = (depth > 0).astype(np.float32)
    return batch


def _jax_noise(rng, fields, dtype=jnp.float32):
    """The draws compute_losses_* make per scale, in `dtype` (x64 on for
    float64): (N, H, W, 1) for the hints loss, which reduces the identity
    losses first; one channel per source frame for compute_losses_mdp."""
    opts = JOptions(**fields)
    c = 1 if opts.use_depth_hints else len(opts.all_frame_ids) - 1
    out = {}
    with jax.enable_x64(dtype == jnp.float64):
        for s in range(4):
            rng, sub = jax.random.split(rng)
            out[s] = torch.from_numpy(np.array(
                jax.random.normal(sub, (N, H, W, c), dtype)))
    return out


def _port_state(tsetup):
    """The port's seeded init (the same weights every call) with the
    disparity heads scaled by 0.1 (the wavelet heads' 3x3 convs, the
    baseline's dispconvs), so no disparity reaches the clamp at 0, where
    depth = 1 / (0.01 + 9.99 disp) turns float32 rounding into 1e5-fold
    larger gradients (tests/test_torch_port_train.py)."""
    state = tsetup.init_state()
    with torch.no_grad():
        for name, block in state.decoder.blocks.items():
            conv = (block[2].conv if "_pos" in name or "_neg" in name
                    else block.conv if name.startswith("dispconv_")
                    else None)
            if conv is not None:
                conv.weight.mul_(0.1)
                conv.bias.mul_(0.1)
    return state


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_variables(tstate):
    """(params, batch_stats) of the port's state, read by the JAX
    package's importers."""
    enc = _np_sd(tstate.encoder)
    ev = (jti.import_mobilenetv2_encoder(enc) if "features.0.0.weight" in enc
          else jti.import_resnet_encoder(enc, 18))
    dec = _np_sd(tstate.decoder)
    dv = (jti.import_kitti_wavelet_decoder(dec) if "waveconv_4_ll" in
          tstate.decoder.blocks else jti.import_kitti_baseline_decoder(dec))
    params = {"encoder": ev["params"], "depth": dv["params"]}
    stats = {"encoder": ev["batch_stats"]}
    if tstate.pose_encoder is not None:
        pv = jti.import_resnet_encoder(_np_sd(tstate.pose_encoder), 18)
        params["pose_encoder"] = pv["params"]
        stats["pose_encoder"] = pv["batch_stats"]
    if tstate.pose is not None:
        sd = _np_sd(tstate.pose)
        params["pose"] = (jti.import_pose_cnn(sd) if "pose_conv.weight" in sd
                          else jti.import_pose_decoder(sd))["params"]
    return params, stats


def _jax_trees(tree):
    """{port parameter name: tensor} of a JAX params-shaped tree."""
    return ti.param_trees_from_jax(
        tree["encoder"], tree["depth"],
        pose_encoder_tree=tree.get("pose_encoder"), pose_tree=tree.get("pose"))


def _named(tstate, attr=None):
    return {f"{prefix}.{name}": (p if attr is None else getattr(p, attr))
            .detach().numpy().copy()
            for prefix, m in tstate.modules().items()
            for name, p in m.named_parameters()}


def _bn_stats(tstate):
    return {f"{prefix}.{k}": v.numpy().copy()
            for prefix in ("encoder", "pose_encoder")
            if prefix in tstate.modules()
            for k, v in tstate.modules()[prefix].state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _setups(name, **extra):
    """(fields, JAX setup, port setup, port state, JAX params, JAX batch
    statistics); JAX's setup is not initialised (an eager flax init costs
    tens of seconds on the CPU): its variables are the port's."""
    fields = dict(BASE, **CONFIGS[name], **extra)
    jsetup = JSetup(JOptions(**fields), steps_per_epoch=10)
    tsetup = TSetup(TOptions(**fields, device="cpu"), steps_per_epoch=10)
    tstate = _port_state(tsetup)
    return (fields, jsetup, tsetup, tstate) + _jax_variables(tstate)


def _jax_forward(jsetup, dtype=jnp.float32, cast_params=None):
    """JAX's training forward of a uint8 batch: (losses, new BN stats);
    `cast_params` casts the params and color_aug (the mixed-precision
    step's bfloat16 networks)."""
    def forward(params, stats, inputs, r):
        inputs = jaug.expand_batch(inputs, jnp)
        inputs = {k: v.astype(dtype) if jnp.issubdtype(v.dtype, jnp.floating)
                  else v for k, v in inputs.items()}
        if cast_params is not None:
            params = jcast(params, cast_params)
            inputs = {k: v.astype(cast_params) if k[0] == "color_aug" else v
                      for k, v in inputs.items()}
        _, losses, new_stats = jsetup.forward(params, stats, inputs, r,
                                              train=True)
        return losses, new_stats
    return forward


@pytest.fixture(scope="module", params=["ms", "cnn_all"])
def one_step(request):
    """JAX's float64 gradient, losses and BN statistics of the first step
    (x64 on) and the port's float64 forward and backward, on the same
    weights and one float64 batch; the port's float32 train step on the
    uint8 batch."""
    fields, jsetup, tsetup, tstate, params, stats = _setups(request.param)
    batch = _batch(fields)
    rng = jax.random.PRNGKey(7)
    forward = _jax_forward(jsetup, jnp.float64)

    def loss_fn(p, st, inputs, r):
        losses, new_stats = forward(p, st, inputs, r)
        return losses["loss"], (losses, new_stats)

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # one float64 batch for both: the uint8 feed expanded (and jittered)
    # by the port in float32, then widened
    ins = {k: v.double() if v.is_floating_point() else v
           for k, v in taug.expand_batch(tbatch).items()}
    with jax.enable_x64(True):
        p64, s64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), (params, stats))
        grads, (jlosses, new_stats) = jax.device_get(jax.jit(jax.grad(
            loss_fn, has_aux=True))(p64, s64, {k: jnp.asarray(v.numpy())
                                                for k, v in ins.items()},
                                    rng))
    tlosses = tsetup.train_step(tstate, tbatch, _jax_noise(rng, fields))
    # the port in float64
    state64 = _port_state(tsetup)
    for m in state64.modules().values():
        m.double()
    _, losses64 = tsetup.forward(state64, ins,
                                 _jax_noise(rng, fields, jnp.float64),
                                 train=True)
    losses64["loss"].backward()
    jstats = {}
    for prefix in ("encoder", "pose_encoder"):
        if prefix in new_stats:
            sd = ti.state_dicts_from_jax(
                {"params": params[prefix],
                 "batch_stats": new_stats[prefix]}, None)[0]
            jstats.update({f"{prefix}.{k}": v.numpy() for k, v in sd.items()
                           if k.endswith(("running_mean", "running_var"))})
    return dict(name=request.param, jlosses=jlosses, tlosses=tlosses,
                tlosses64={k: v.detach() for k, v in losses64.items()},
                jgrads=_jax_trees(grads), g64=_named(state64, "grad"),
                jstats=jstats, tstats=_bn_stats(tstate), tstate=tstate,
                jparams=params)


def _assert_losses(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_losses_match_jax(one_step):
    _assert_losses(one_step["tlosses"], one_step["jlosses"])
    j, t = one_step["jlosses"], one_step["tlosses64"]
    for k in j:
        assert t[k].dtype == torch.float64
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-7,
                                   err_msg=k)


def test_every_gradient_matches_jax(one_step):
    j, g64 = one_step["jgrads"], one_step["g64"]
    assert set(j) == set(g64) == set(_named(one_step["tstate"]))
    prefixes = {k.split(".")[0] for k in j}
    assert prefixes == ({"encoder", "depth", "pose_encoder", "pose"}
                        if one_step["name"] == "ms"
                        else {"encoder", "depth", "pose"})
    big = max(np.linalg.norm(v) for v in g64.values())
    for k, exact in g64.items():
        scale = np.linalg.norm(exact)
        assert scale > 0, k
        err = np.linalg.norm(j[k].numpy() - exact)
        assert err <= 5e-5 * scale + 1e-12 * big, (k, err, scale)


def test_bn_running_stats_match_jax(one_step):
    j, t = one_step["jstats"], one_step["tstats"]
    assert set(j) == set(t)
    assert any(k.startswith("pose_encoder.") for k in t) == \
        (one_step["name"] == "ms")
    for k, v in t.items():
        np.testing.assert_allclose(v, j[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_decay_groups_match_jax(one_step):
    """JAX's `_decay_mask`: every parameter of the encoder and both pose
    nets decays, biases included; in the depth decoder only kernels."""
    params = one_step["jparams"]
    masked = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32),
        joptim._decay_mask(params), params)
    jmask = {k: bool(v.numpy().all()) for k, v in _jax_trees(masked).items()}
    state = one_step["tstate"]
    pose = [m for m in (state.pose_encoder, state.pose) if m is not None]
    decay, no_decay = toptim.decay_groups(state.encoder, state.decoder, pose)
    ids = {id(p): True for p in decay}
    ids.update({id(p): False for p in no_decay})
    named = {f"{pre}.{n}": p for pre, m in state.modules().items()
             for n, p in m.named_parameters()}
    assert {k: ids[id(p)] for k, p in named.items()} == jmask
    assert all(jmask[k] for k in jmask if k.startswith("pose"))
    sizes = [len(g["params"]) for g in state.optimizer.param_groups]
    assert sizes == [len(decay), len(no_decay)]


@pytest.mark.parametrize("name", ["cnn_pairs", "baseline", "mobilenet"])
def test_first_step_losses_match_jax(name):
    """The other configurations: the port's first train step returns JAX's
    losses of the same forward, and moves every network."""
    fields, jsetup, tsetup, tstate, params, stats = _setups(name)
    batch = _batch(fields)
    rng = jax.random.PRNGKey(7)
    jlosses, _ = jax.jit(_jax_forward(jsetup))(
        params, stats, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    before = _named(tstate)
    tlosses = tsetup.train_step(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        _jax_noise(rng, fields))
    _assert_losses(tlosses, jlosses)
    after = _named(tstate)
    for prefix in tstate.modules():
        assert any(not np.array_equal(after[k], before[k]) for k in after
                   if k.startswith(prefix + ".")), prefix


def test_mixed_precision_ms_step_matches_jax():
    """The bf16 mixed-precision M+S step: losses within 1e-2 of JAX's
    mixed-precision forward (its step's losses: bfloat16 params and
    color_aug), float32 masters, gradients, Adam moments and BN
    statistics, the pose nets' included."""
    fields, jsetup, tsetup, tstate, params, stats = _setups("ms",
                                                            bfloat16=True)
    batch = _batch(fields)
    rng = jax.random.PRNGKey(7)
    jlosses, _ = jax.jit(_jax_forward(jsetup, cast_params=jnp.bfloat16))(
        params, stats, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    tlosses = tsetup.train_step(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        _jax_noise(rng, fields))
    assert set(tlosses) == set(jlosses)
    for k in jlosses:
        assert tlosses[k].dtype == torch.float32
        ref = float(jlosses[k])
        assert abs(float(tlosses[k]) - ref) <= 1e-2 * abs(ref), (
            k, float(tlosses[k]), ref)
    for name, m in tstate.modules().items():
        for pname, p in m.named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, (name, pname)
        for b in m.buffers():
            assert not b.is_floating_point() or b.dtype == torch.float32
    for moments in tstate.optimizer.state_dict()["state"].values():
        assert all(v.dtype == torch.float32 for v in moments.values())


@pytest.mark.parametrize("kw,match", [
    (dict(pose_model_type="shared"), "Queue 3: JAX's 'shared' pose mode"),
    (dict(encoder_type="mobilenet", weights_init="pretrained",
          imagenet_weights_path="resnet18.pth"),
     "Queue 3: JAX's KITTI ImageNet start on MobileNetV2")])
def test_what_jax_cannot_run_raises(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        TSetup(TOptions(**dict(BASE, frame_ids=(0, -1, 1), **kw),
                        device="cpu")).init_state()


@pytest.mark.parametrize("name", ["ms", "baseline"])
def test_disp_head_surgery_matches_jax(name):
    """--disp_head_bias sets every disparity head's bias as JAX's
    `_disp_head_surgery` does: the wavelet decoder's LL head, the
    baseline's dispconv_0..3."""
    _, jsetup, _, tstate, params, _ = _setups(name, disp_head_bias=-4.0)
    jparams = jsetup._disp_head_surgery(
        jax.tree_util.tree_map(np.array, params))
    tsetup = TSetup(TOptions(**dict(BASE, **CONFIGS[name],
                                    disp_head_bias=-4.0), device="cpu"))
    state = tsetup.init_state()
    ref = ti.state_dicts_from_jax(None, {"params": jparams["depth"]})[1]
    ours = state.decoder.state_dict()
    heads = [k for k in ours if k.endswith("bias")
             and torch.all(ours[k] == -4.0)]
    assert len(heads) == (4 if name == "baseline" else 1)
    for k in heads:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy())


def test_pose_encoder_bn_modes():
    """The pose encoder's BN runs in train mode inside the step (its
    running statistics move) and on its running statistics in the eval
    step (they stay)."""
    fields, _, tsetup, state, _, _ = _setups("ms")
    batch = {k: torch.from_numpy(v) for k, v in _batch(fields).items()}
    noise = torch.Generator().manual_seed(0)

    def stats():
        return {k: v.clone() for k, v in
                state.pose_encoder.state_dict().items()
                if k.endswith("running_mean")}
    before = stats()
    tsetup.eval_step(state, batch, noise)
    assert not state.pose_encoder.training
    assert all(torch.equal(v, before[k]) for k, v in stats().items())
    tsetup.train_step(state, batch, noise)
    assert state.pose_encoder.training
    assert all(not torch.equal(v, before[k]) for k, v in stats().items())


def test_pose_imagenet_start(tmp_path):
    """weights_init=pretrained: the depth encoder takes the torchvision
    state dict, the pose encoder its stem tiled over the 2 frames / 2, as
    JAX's import_resnet_encoder_multiimage."""
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
    tv = init_params(ResnetEncoder(18), torch.Generator().manual_seed(3))
    sd = {k[len("encoder."):]: v for k, v in tv.state_dict().items()}
    sd["fc.weight"] = torch.zeros(1000, 512)
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    opts = TOptions(**dict(BASE, **CONFIGS["ms"], weights_init="pretrained",
                           imagenet_weights_path=path), device="cpu")
    state = TSetup(opts).init_state()
    w = sd["conv1.weight"]
    assert torch.equal(state.encoder.encoder.conv1.weight, w)
    assert torch.equal(state.pose_encoder.encoder.conv1.weight,
                       torch.cat([w, w], dim=1) / 2)
    assert torch.equal(state.pose_encoder.encoder.layer4[1].bn2.running_var,
                       sd["layer4.1.bn2.running_var"])


# --- the training CLI --------------------------------------------------------

def test_train_main_ms_checkpoint_and_resume(tmp_path):
    """M+S + hints through tools/train_kitti.main on a tiny mount whose
    split holds interior frames only: pose_encoder.pth / pose.pth in
    float32 beside the others, adam.pth holding the pose nets' moments,
    and --auto_resume requiring the pose files."""
    from test_torch_port_data import write_mount
    root = str(tmp_path / "kitti")
    lines = write_mount(root, 6, 75, 124)
    for name in ("train_files.txt", "val_files.txt"):
        with open(os.path.join(root, "splits", "tiny", name), "w") as f:
            f.write("\n".join(lines[1:5]) + "\n")
    log = str(tmp_path / "log")
    argv = ["--data_path", root, "--split", "tiny", "--log_dir", log,
            "--model_name", "ms", "--height", str(H), "--width", str(W),
            "--batch_size", "2", "--num_epochs", "1", "--use_stereo",
            "--frame_ids", "0", "-1", "1", "--use_depth_hints",
            "--use_wavelets", "--weights_init", "scratch",
            "--log_frequency", "1", "--num_workers", "2", "--device", "cpu"]
    summary = train_kitti.main(argv)
    assert summary["steps"] == 2 and summary["val_batches"] == 2
    assert all(np.isfinite(v) for d in summary["losses"] for v in d.values())
    folder = summary["checkpoints"][-1]
    files = sorted(os.listdir(folder))
    assert files == ["adam.pth", "depth.pth", "encoder.pth", "pose.pth",
                     "pose_encoder.pth"]
    for f in files:
        sd = torch.load(os.path.join(folder, f), weights_only=True)
        flat = list(sd["state"].values()) if "state" in sd else [sd]
        assert {v.dtype for d in flat for v in d.values()
                if torch.is_tensor(v) and v.is_floating_point()} == \
            {torch.float32}, f
    opts = TOptions(**dict(BASE, **CONFIGS["ms"]), device="cpu")
    state = TSetup(opts).init_state()
    n_params = sum(1 for m in state.modules().values()
                   for _ in m.parameters())
    adam = torch.load(os.path.join(folder, "adam.pth"), weights_only=True)
    assert len(adam["state"]) == n_params
    ckpt.load_checkpoint(folder, state)
    for name in ("pose_encoder", "pose"):
        ref = torch.load(os.path.join(folder, f"{name}.pth"),
                         weights_only=True)
        for k, v in state.modules()[name].state_dict().items():
            assert torch.equal(v, ref[k]), (name, k)
    os.remove(os.path.join(folder, "pose.pth"))
    assert ckpt.latest_checkpoint(log + "/ms",
                                  ckpt.checkpoint_files(state)) is None
    assert ckpt.latest_checkpoint(log + "/ms") == folder


def test_train_main_odometry_then_evaluate_pose(tmp_path):
    """Monocular training on the odometry layout (--dataset kitti_odom,
    tests/test_cli_e2e_pose.py's tree) writes a checkpoint that
    tools/evaluate_pose.main scores: a finite ATE and poses.npy."""
    from test_torch_port_pose import write_mini_odom
    root = write_mini_odom(tmp_path / "kitti_odom")
    splits = os.path.join(root, "splits", "odom")
    with open(os.path.join(splits, "train_files.txt"), "w") as f:
        f.write("".join(f"9 {i} l\n" for i in range(1, 7)))
    with open(os.path.join(splits, "val_files.txt"), "w") as f:
        f.write("9 2 l\n9 3 l\n")
    log = str(tmp_path / "log")
    summary = train_kitti.main([
        "--data_path", root, "--log_dir", log, "--model_name", "odo",
        "--split", "odom", "--dataset", "kitti_odom", "--png",
        "--height", "64", "--width", "128", "--frame_ids", "0", "-1", "1",
        "--batch_size", "2", "--num_epochs", "1", "--use_wavelets",
        "--weights_init", "scratch", "--log_frequency", "1",
        "--num_workers", "2", "--device", "cpu"])
    folder = summary["checkpoints"][-1]
    out = tevp.main(["--data_path", root, "--eval_split", "odom_9",
                     "--height", "64", "--width", "128",
                     "--splits_dir", os.path.join(root, "splits"),
                     "--load_weights_folder", folder, "--device", "cpu"])
    assert np.isfinite(out["ate_mean"]) and out["poses"].shape == (7, 4, 4)
    assert os.path.isfile(os.path.join(folder, "poses.npy"))

