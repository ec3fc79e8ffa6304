"""Port parity, the NYUv2 train step: wavelet_monodepth_tpu_torch's
NyuTrainSetup against the JAX package's on the same weights (crossed by
tools/torch_import.py) and the same uint8 batch, mobilenet_light +
NyuDecoderWave at 64x96 (depth 32x48), batch 2, as the JAX package's own
NYU tests shrink it; DenseNet161's train-mode losses at 64x96, batch 1;
the 224 decoder's LL term, --disparity, the mixed-precision step, the
ImageNet start, the mesh flags and the learning contract.

The step runs twice: in float32, and in float64 on both sides (JAX with
x64 on), which holds the two functions equal where float32 rounding
cannot: the loss gradient has one sign everywhere, so BN's backward over
12-48 values per channel cancels and the float32 gradients lie up to 1%
from exact.

Tolerances, each with its reason:
  * losses: 1e-5 relative in float32 (sums in another order), 1e-7 in
    float64 (the port returns its losses as float32);
  * gradients, against the port's float64 gradient: JAX's float64 one
    within 1e-8 of each tensor's norm, each float32 one within 2% (the
    cancellation above), plus a floor for gradients that are exactly 0;
  * Adam's first step, lr g / (|g| + eps): wherever |g| exceeds 10x the
    two gradients' largest disagreement d in its tensor, the two updates
    agree within lr eps d / g^2 + 1e-5 lr (1e-12 lr in float64) + 2 ulp
    of the parameter; no update is larger than lr (1 + 1e-4) plus the
    parameter's rounding;
  * BN running statistics (flax's biased variance): 1e-10 relative in
    float64; 1e-4 relative and 1e-5 absolute in float32;
  * the eval step on the same state: 1e-5;
  * the mixed-precision step: every loss within 1e-3 relative of JAX's
    mixed-precision step (bfloat16 networks on both sides); its masters,
    BN statistics and Adam moments float32;
  * DenseNet161 train-mode losses: 1e-5 relative.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavelet_monodepth_tpu.ops import augment as jaug
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.train.nyu import NyuTrainSetup as JSetup
from wavelet_monodepth_tpu.train.nyu import depth_norm as jdepth_norm
from wavelet_monodepth_tpu.utils.config import NyuOptions as JOptions
from wavelet_monodepth_tpu_torch.models.factory import make_nyu_encoder
from wavelet_monodepth_tpu_torch.ops.augment import expand_nyu
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.tools import train_nyu
from wavelet_monodepth_tpu_torch.train.nyu import NyuTrainSetup as TSetup
from wavelet_monodepth_tpu_torch.train.nyu import depth_norm
from wavelet_monodepth_tpu_torch.utils.config import NyuOptions as TOptions
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
H, W, N = 64, 96, 2
LR = 1e-4
FIELDS = dict(encoder_type="mobilenet_light", use_wavelets=True,
              pretrained_encoder=False, lr=LR, batch_size=N)


def _setups(**kw):
    """(JAX setup, port setup) of one configuration, shrunk to 64x96."""
    j = JSetup(JOptions(**FIELDS, **kw))
    t = TSetup(TOptions(**FIELDS, **kw, device="cpu"))
    for s in (j, t):
        s.input_hw = (H, W)
        s.depth_hw = (H, W) if kw.get("use_224") else (H // 2, W // 2)
    return j, t


def _batch(seed=0, n=N, depth_hw=(H // 2, W // 2)):
    """uint8 feed: a smooth image and 8-bit depths (-> 39-1000 cm)."""
    rs = np.random.RandomState(seed)
    tex = rs.rand(n, H, W, 3)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 2)) / 3.0
    depth = rs.randint(10, 256, (n,) + depth_hw + (1,))
    return (tex * 255).astype(np.uint8), depth.astype(np.uint8)


def _cross(jstate, tstate):
    p, bs = jstate.params, jstate.batch_stats
    enc_sd, dec_sd = ti.state_dicts_from_jax(
        {"params": p["encoder"], "batch_stats": bs["encoder"]},
        {"params": p["decoder"]})
    ti.load_state_dicts(tstate.encoder, tstate.decoder, enc_sd, dec_sd)


def _named(tstate, attr=None):
    """{name: parameter (or its .grad) as numpy}. mobilenet_light's last
    two blocks feed no tap: their .grad is None, JAX's gradient zeros."""
    out = {}
    for prefix, m in (("encoder", tstate.encoder),
                      ("decoder", tstate.decoder)):
        for name, prm in m.named_parameters():
            v = prm if attr is None else getattr(prm, attr)
            v = torch.zeros_like(prm) if v is None else v
            out[f"{prefix}.{name}"] = v.detach().numpy().copy()
    return out


def _fresh(jstate):
    """A copy of a JAX state, for a step that donates its input."""
    return jax.tree_util.tree_map(jnp.copy, jstate)


def _jax_ref_step(jsetup, jstate, image, depth, dtype=jnp.float32):
    """JAX's step with its parts exposed: (grads, losses, new batch stats,
    new params). float64: the state cast and the step traced with x64 on;
    feed it float64 image and depth."""
    def loss_fn(params, stats, image, depth):
        image, depth = jaug.expand_nyu(image, depth, jnp)
        target = jdepth_norm(depth) if jsetup.opts.disparity else depth
        outputs, new_stats = jsetup.forward(params, stats, image, train=True)
        losses = jsetup.compute_losses(outputs, target)
        return losses["loss"], (losses, new_stats)

    def ref_step(params, stats, opt_state, image, depth):
        grads, (losses, new_stats) = jax.grad(loss_fn, has_aux=True)(
            params, stats, image, depth)
        updates, _ = jsetup.optimizer.update(grads, opt_state, params)
        return grads, losses, new_stats, optax.apply_updates(params, updates)

    with jax.enable_x64(dtype == jnp.float64):
        args = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dtype) if jnp.issubdtype(
                a.dtype, jnp.floating) else a,
            (jstate.params, jstate.batch_stats, jstate.opt_state))
        out = jax.jit(ref_step)(*args, jnp.asarray(image),
                                jnp.asarray(depth))
        return jax.tree_util.tree_map(np.asarray, jax.device_get(out))


@pytest.fixture(scope="module")
def jax_init():
    jsetup, _ = _setups()
    return jsetup.init_state(jax.random.PRNGKey(0))


def _port_step(tsetup, jstate, image, depth, dtype=torch.float32):
    """The port's step on crossed weights: (losses, grads, params before,
    params after, BN running statistics, state)."""
    state = tsetup.init_state()
    _cross(jstate, state)
    if dtype == torch.float64:
        state.encoder.double()
        state.decoder.double()
        state.optimizer = torch.optim.Adam(
            [p for m in (state.encoder, state.decoder)
             for p in m.parameters()], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    before = _named(state)
    losses = tsetup.train_step(state, torch.from_numpy(image),
                               torch.from_numpy(depth))
    stats = {k: v.numpy() for k, v in state.encoder.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return losses, _named(state, "grad"), before, _named(state), stats, state


def _jax_named(grads, new_stats, new_params):
    return (ti.param_trees_from_jax(grads["encoder"], grads["decoder"],
                                    decoder_scope="decoder"),
            ti.param_trees_from_jax(new_params["encoder"],
                                    new_params["decoder"],
                                    decoder_scope="decoder"),
            ti.state_dicts_from_jax({"params": new_params["encoder"],
                                     "batch_stats": new_stats["encoder"]},
                                    None)[0])


@pytest.fixture(scope="module")
def one_step(jax_init):
    """Both frameworks' first train step on one uint8 batch in float32,
    and again in float64 on the same batch expanded in float64."""
    jsetup, tsetup = _setups()
    image, depth = _batch()
    out = {}
    for name, jdt, tdt, feed in (
            ("f32", jnp.float32, torch.float32, (image, depth)),
            ("f64", jnp.float64, torch.float64,
             (image / 255.0, np.clip(depth / 255.0 * 1000.0, 10.0, 1000.0)))):
        grads, losses, new_stats, new_params = _jax_ref_step(
            jsetup, jax_init, *feed, dtype=jdt)
        jg, jp, js = _jax_named(grads, new_stats, new_params)
        tl, tg, before, tp, ts, state = _port_step(tsetup, jax_init, *feed,
                                                   dtype=tdt)
        out[name] = dict(jlosses=losses, jgrads=jg, jparams=jp, jstats=js,
                         tlosses=tl, tgrads=tg, before=before, tparams=tp,
                         tstats=ts, tstate=state)
    return out


def test_losses_match_jax(one_step):
    j, t = one_step["f32"]["jlosses"], one_step["f32"]["tlosses"]
    assert set(j) == set(t)
    # the 640x480 decoder has no ("wavelets", 3, "LL"): no LL term (JAX's
    # and the reference's quirk)
    assert "loss_LL3" not in t and "loss_depth/0" in t
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-5,
                                   err_msg=k)
        assert t[k].dtype == torch.float32 and t[k].device.type == "cpu"
    assert one_step["f32"]["tstate"].step == 1
    j64, t64 = one_step["f64"]["jlosses"], one_step["f64"]["tlosses"]
    for k in j64:      # the port returns float32 losses
        np.testing.assert_allclose(float(t64[k]), float(j64[k]), rtol=1e-7,
                                   err_msg=k)


def test_every_gradient_matches_jax(one_step):
    """Against the port's float64 gradient, G the largest tensor norm of
    it: JAX's float64 gradient within 1e-8 of each tensor's norm plus
    1e-12 G; each framework's float32 gradient within 2% of the norm plus
    1e-6 G. BN over 12-48 values per channel and a loss gradient of one
    sign everywhere make float32 cancel (0.5-0.9% at worst here); the G
    term covers the BN shifts whose exact gradient is 0 (the next BN
    removes any per-channel constant)."""
    g32, g64 = one_step["f32"], one_step["f64"]
    assert set(g64["jgrads"]) == set(g64["tgrads"]) == set(g32["jgrads"]) \
        == set(g32["tgrads"])
    assert len(g64["tgrads"]) == sum(
        1 for m in (g32["tstate"].encoder, g32["tstate"].decoder)
        for _ in m.parameters())
    big = max(np.linalg.norm(v) for v in g64["tgrads"].values())
    for k, exact in g64["tgrads"].items():
        scale = np.linalg.norm(exact)
        assert np.linalg.norm(g64["jgrads"][k].numpy() - exact) <= \
            1e-8 * scale + 1e-12 * big, k
        for g in (g32["jgrads"][k].numpy(), g32["tgrads"][k]):
            err = np.linalg.norm(np.asarray(g, np.float64) - exact)
            assert err <= 2e-2 * scale + 1e-6 * big, (k, err, scale)


def _adam_agrees(run, eps_rel):
    """Adam's first step, lr g / (|g| + eps): no update larger than
    lr (1 + 1e-4) plus the parameter's rounding; wherever |g| exceeds 10x
    the two gradients' largest disagreement d in its tensor, the updates
    agree within lr eps d / g^2 + eps_rel lr + 2 ulp of the parameter.
    Returns the share of elements decided."""
    n_decided = n_all = 0
    for k, ref in run["jparams"].items():
        before = run["before"][k]
        g = run["jgrads"][k].numpy()        # no weight decay
        step_t = run["tparams"][k] - before
        step_j = ref.numpy() - before
        ulp = np.spacing(np.abs(before).max())
        assert np.abs(step_t).max() <= LR * (1 + 1e-4) + 2 * ulp, k
        noise = np.abs(run["tgrads"][k] - g).max()
        decided = np.abs(g) > 10 * noise
        n_decided += decided.sum()
        n_all += decided.size
        tol = (LR * 1e-8 * noise / g[decided] ** 2 + eps_rel * LR
               + 2 * np.spacing(np.abs(before[decided])))
        assert (np.abs(step_t - step_j)[decided] <= tol).all(), k
    return n_decided / n_all


def test_params_after_adam_step_match_jax(one_step):
    # undecided: the two unused blocks' zero gradients, the BN shifts
    # whose exact gradient is 0, and float32's noise
    assert _adam_agrees(one_step["f32"], 1e-5) > 0.3
    assert _adam_agrees(one_step["f64"], 1e-12) > 0.5


def test_bn_running_stats_biased_variance(one_step):
    """float64: within 1e-10 relative (1e-12 absolute); float32: 1e-4
    relative, 1e-5 absolute (the last blocks' statistics, over 12-48
    values per channel, carry their inputs' float32 rounding: up to 3e-5
    here)."""
    for name, rtol, atol in (("f64", 1e-10, 1e-12), ("f32", 1e-4, 1e-5)):
        j, t = one_step[name]["jstats"], one_step[name]["tstats"]
        assert len(t) == 2 * sum(
            1 for m in one_step[name]["tstate"].encoder.modules()
            if isinstance(m, torch.nn.BatchNorm2d))
        for k, v in t.items():
            np.testing.assert_allclose(v, j[k].numpy(), rtol=rtol, atol=atol,
                                       err_msg=f"{name} {k}")


def test_eval_step_matches_jax(jax_init):
    """The eval step (BN running statistics, uint8 image) on the state
    JAX's own step leaves, crossed into the port."""
    jsetup, tsetup = _setups()
    image, _ = _batch(seed=1)
    jstate = jsetup.jit_train_step()(_fresh(jax_init),
                                     *map(jnp.asarray, _batch()))[0]
    ref = jax.jit(jsetup.make_eval_step())(jstate, jnp.asarray(image))
    tstate = tsetup.init_state()
    _cross(jstate, tstate)
    ours = tsetup.eval_step(tstate, torch.from_numpy(image))
    assert not tstate.encoder.training
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=str(k))


def test_224_decoder_supervises_ll(jax_init):
    """NyuDecoderWave224 has ("wavelets", 3, "LL"): loss_LL3 is
    |LL3 - DWT_J=4(target) LL| / 16, and --supervise_LL adds it."""
    jsetup, tsetup = _setups(use_224=True, supervise_LL=True)
    jstate = jsetup.init_state(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    image = rs.rand(1, H, W, 3).astype(np.float32)
    depth = (rs.rand(1, H, W, 1) * 990 + 10).astype(np.float32)
    outputs, _ = jsetup.forward(jstate.params, jstate.batch_stats,
                                jnp.asarray(image), train=False)
    ref = jsetup.compute_losses(outputs, jnp.asarray(depth))
    tstate = tsetup.init_state()
    _cross(jstate, tstate)
    with torch.no_grad():
        ours = tsetup.compute_losses(
            tsetup.forward(tstate, torch.from_numpy(image), train=False),
            torch.from_numpy(depth))
    assert "loss_LL3" in ours and set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    manual = sum(float(ours[f"loss/{s}"]) for s in range(4)
                 if f"loss/{s}" in ours) + float(ours["loss_LL3"])
    np.testing.assert_allclose(float(ours["loss"]), manual, rtol=1e-6)


def test_disparity_step_matches_jax(jax_init):
    """--disparity trains on 10 / depth. Its loss is a mean of |pred -
    target| with targets of 0.04-1 against outputs of the same size, so
    float32 rounding of the outputs shows in it: JAX's float32 losses must
    lie within 3x the port's own float32 error (plus 1e-7 relative) of the
    port's float64 losses."""
    jsetup, tsetup = _setups(disparity=True)
    image, depth = _batch(seed=2)
    _, losses, _, _ = _jax_ref_step(jsetup, jax_init, image, depth)
    tstate = tsetup.init_state()
    _cross(jax_init, tstate)
    ours = tsetup.train_step(tstate, torch.from_numpy(image),
                             torch.from_numpy(depth))
    state64 = tsetup.init_state()
    _cross(jax_init, state64)
    state64.encoder.double()
    state64.decoder.double()
    img, dep = expand_nyu(torch.from_numpy(image), torch.from_numpy(depth))
    with torch.no_grad():
        exact = tsetup.compute_losses(
            tsetup.forward(state64, img.double(), train=True),
            depth_norm(dep.double()))
    assert set(ours) == set(losses) == set(exact)
    for k in losses:
        e_port = abs(float(ours[k]) - float(exact[k]))
        e_jax = abs(float(losses[k]) - float(exact[k]))
        assert e_jax <= 3 * e_port + 1e-7 * abs(float(exact[k])), (
            k, e_jax, e_port)
    d = torch.tensor([[1.0, 2.0, 10.0]])
    assert torch.equal(depth_norm(d), torch.tensor([[10.0, 5.0, 1.0]]))


def _float_dtypes(state) -> set:
    tensors = [t for m in (state.encoder, state.decoder)
               for t in list(m.parameters()) + list(m.buffers())]
    tensors += [v for d in state.optimizer.state.values()
                for v in d.values() if torch.is_tensor(v)]
    return {t.dtype for t in tensors if t.is_floating_point()}


def test_mixed_precision_step_matches_jax(jax_init):
    jsetup, _ = _setups()
    _, tsetup = _setups(bfloat16=True)
    image, depth = _batch()
    jstate = _fresh(jax_init)
    step = jsetup.jit_train_step(mixed_precision=True)
    tstate = tsetup.init_state()
    _cross(jstate, tstate)
    for i in range(2):
        jstate, ref = step(jstate, jnp.asarray(image), jnp.asarray(depth))
        ours = tsetup.train_step(tstate, torch.from_numpy(image),
                                 torch.from_numpy(depth))
        assert set(ours) == set(ref)
        for k in ref:
            assert ours[k].dtype == torch.float32, k
            np.testing.assert_allclose(float(ours[k]), float(ref[k]),
                                       rtol=1e-3, err_msg=f"{i} {k}")
    assert _float_dtypes(tstate) == {torch.float32}
    assert {p.grad.dtype for m in (tstate.encoder, tstate.decoder)
            for p in m.parameters() if p.grad is not None} == {torch.float32}


def _random_vars(init, *args, seed: int):
    """numpy variables of init(key, *args)'s shapes (`jax.eval_shape`; an
    eager flax init of DenseNet161 takes over a minute): kernels N(0,
    2 / fan_in), biases and BN shifts and means 0.1 N(0, 1), BN scales
    1 + 0.1 N(0, 1), variances 1 + 0.2 U."""
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


def test_densenet161_train_losses_match_jax():
    """The published encoder in train mode (batch statistics) at 64x96,
    B=1: the losses of the same weights and batch."""
    opts = dict(encoder_type="densenet", use_wavelets=True,
                pretrained_encoder=False)
    jsetup = JSetup(JOptions(**opts))
    tsetup = TSetup(TOptions(**opts, device="cpu"))
    image, depth = _batch(seed=3, n=1)
    x = jnp.asarray(image, jnp.float32) / 255.0
    ev = _random_vars(jsetup.encoder.init, x, seed=1)
    feats = jax.eval_shape(jsetup.encoder.apply, ev, x)
    dv = _random_vars(jsetup.decoder.init, feats, seed=2)
    params = {"encoder": ev["params"], "decoder": dv["params"]}
    stats = {"encoder": ev["batch_stats"]}

    @jax.jit
    def ref(params, stats, image, depth):
        image, depth = jaug.expand_nyu(image, depth, jnp)
        outputs, _ = jsetup.forward(params, stats, image, train=True)
        return jsetup.compute_losses(outputs, depth)
    want = ref(params, stats, jnp.asarray(image), jnp.asarray(depth))
    tstate = tsetup.init_state()
    _cross(SimpleNamespace(params=params, batch_stats=stats), tstate)
    with torch.no_grad():
        img, dep = (torch.from_numpy(a) for a in (image, depth))
        img, dep = expand_nyu(img, dep)
        ours = tsetup.compute_losses(tsetup.forward(tstate, img, train=True),
                                     dep)
    assert set(ours) == set(want)
    for k in want:
        np.testing.assert_allclose(float(ours[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def _twin_batch(n=N, seed=0):
    """The learning contract's fixed batch: a seeded image, and depth a
    vertical ramp of 100-500 cm plus 0-20 cm of noise."""
    rs = np.random.RandomState(seed)
    image = rs.rand(n, H, W, 3).astype(np.float32)
    ramp = np.linspace(100.0, 500.0, H // 2)[None, :, None, None]
    depth = ramp + 20.0 * rs.rand(n, H // 2, W // 2, 1)
    return torch.from_numpy(image), torch.from_numpy(depth.astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True])
def test_learning_contract(bf16):
    """mobilenet_light at 64x96, B=2, lr 1e-4: the loss of one fixed
    batch falls by at least 10% in 30 steps."""
    _, tsetup = _setups(bfloat16=bf16)
    state = tsetup.init_state(torch.Generator().manual_seed(0))
    image, depth = _twin_batch()
    losses = [float(tsetup.train_step(state, image, depth)["loss"])
              for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] <= 0.9 * losses[0], losses


@pytest.mark.parametrize("flag", [("data_axis", 2),
                                  ("coordinator_address", "localhost:1"),
                                  ("num_processes", 2)])
def test_mesh_flags_raise(flag):
    """The mesh flags run data-parallel training
    (tests/test_torch_port_ddp.py); what cannot run raises before any
    rank starts: a setup whose data_axis differs from its process group's
    ranks, a batch that does not divide across the data mesh (JAX's
    SystemExit message), half-given multi-host flags."""
    opts = dataclasses.replace(TOptions(**FIELDS, device="cpu"),
                               **{flag[0]: flag[1]})
    argv = ["--data_path", "unused.zip", "--device", "cpu",
            f"--{flag[0]}", str(flag[1])]
    if flag[0] == "data_axis":
        with pytest.raises(ValueError, match="data_axis=2 in a process "
                                             "group of 1 rank"):
            TSetup(opts)
        with pytest.raises(SystemExit, match="--batch_size 3 must divide "
                                             "across the 2-device data mesh"):
            train_nyu.main(argv + ["--batch_size", "3"])
    else:
        TSetup(opts)
        with pytest.raises(SystemExit, match="go together"):
            train_nyu.main(argv)


def test_imagenet_init_note_and_guard(capsys, tmp_path):
    """pretrained_encoder without a local state dict: scratch init with
    JAX's note; an encoder without an importer raises SystemExit."""
    opts = TOptions(encoder_type="mobilenet_light", use_wavelets=True,
                    use_224=True, device="cpu")
    TSetup(opts).init_state()
    assert "no --imagenet_weights_path" in capsys.readouterr().out
    opts = dataclasses.replace(opts, imagenet_weights_path=str(tmp_path))
    with pytest.raises(SystemExit, match="no mobilenet_light"):
        TSetup(opts).init_state()


def _torchvision_names(encoder, encoder_type: str) -> dict:
    """A torchvision ImageNet state dict of `encoder`'s weights: its
    names without the port's scope, plus the classifier (and densenet's
    norm5), which no tap reads."""
    g = torch.Generator().manual_seed(7)
    sd = {}
    for k, v in encoder.state_dict().items():
        v = (torch.rand(v.shape, generator=g) + 0.5 if v.is_floating_point()
             else v)
        scope = "original_model." if encoder_type == "densenet" else \
            "encoder."
        sd[k[len(scope):]] = v
    if encoder_type == "densenet":
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"features.norm5.{k}"] = torch.ones(2208)
        sd["classifier.weight"] = torch.zeros(1000, 2208)
    else:
        sd["fc.weight"] = torch.zeros(1000, 512)
    return sd


@pytest.mark.parametrize("encoder_type,num_layers",
                         [("densenet", 161), ("resnet", 18)])
def test_imagenet_init_loads_torchvision_weights_as_jax(tmp_path, capsys,
                                                        encoder_type,
                                                        num_layers):
    """--imagenet_weights_path: a torchvision state dict lands in the
    port's encoder where JAX's importer puts it (crossed back through the
    bridge), and the decoder keeps its seeded init."""
    opts = TOptions(encoder_type=encoder_type, num_layers=num_layers,
                    use_wavelets=True, device="cpu")
    enc, _ = make_nyu_encoder(opts)
    sd = _torchvision_names(enc, encoder_type)
    path = str(tmp_path / "imagenet.pth")
    torch.save(sd, path)
    opts = dataclasses.replace(opts, imagenet_weights_path=path)
    state = TSetup(opts).init_state()
    assert f"ImageNet init: {encoder_type} encoder" in \
        capsys.readouterr().out
    npsd = {k: v.numpy() for k, v in sd.items()}
    jvars = (jti.import_densenet_encoder(npsd, prefix="features.")
             if encoder_type == "densenet" else
             jti.import_resnet_encoder(npsd, num_layers, prefix=""))
    want, _ = ti.state_dicts_from_jax(jax.tree_util.tree_map(
        np.asarray, jvars), None)
    got = state.encoder.state_dict()
    assert set(want) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
