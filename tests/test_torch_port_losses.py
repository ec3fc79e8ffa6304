"""Port parity, the training losses and what they stand on: geometry,
SSIM, smoothness and image ops, colour jitter and the uint8 feed's
expansion, and the KITTI loss functions (warps, automasking, hint proxy)
of wavelet_monodepth_tpu_torch against the JAX package, at 64x96, batch 2.

The automask noise is JAX's own draws (the split sequence of
`compute_losses_hints` / `compute_losses_mdp`), injected into the port.
Tolerances: elementwise ops 1e-5 (float32), the jitter 1e-5 (float
colour math in another order), the loss dicts 1e-5 relative, warped
images 1e-4 (see test_losses_hints_match_jax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.ops import augment as jaug
from wavelet_monodepth_tpu.ops import geometry as jgeo
from wavelet_monodepth_tpu.ops import image as jimage
from wavelet_monodepth_tpu.ops import ssim as jssim
from wavelet_monodepth_tpu.train import losses_kitti as jl
from wavelet_monodepth_tpu.utils.config import KittiOptions as JOptions
from wavelet_monodepth_tpu_torch.ops import augment as taug
from wavelet_monodepth_tpu_torch.ops import geometry as tgeo
from wavelet_monodepth_tpu_torch.ops import image as timage
from wavelet_monodepth_tpu_torch.ops import ssim as tssim
from wavelet_monodepth_tpu_torch.train import losses_kitti as tl
from wavelet_monodepth_tpu_torch.utils.config import KittiOptions as TOptions

torch.set_num_threads(1)
H, W, N = 64, 96, 2
RNG = np.random.RandomState(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, atol=1e-5):
    np.testing.assert_allclose(ours.detach().numpy() if torch.is_tensor(ours)
                               else ours, np.asarray(ref), atol=atol,
                               rtol=0)


# --- geometry --------------------------------------------------------------

def test_depth_to_disp_and_disp_to_depth():
    d = RNG.rand(N, H, W, 1).astype(np.float32) * 80
    d[0, :3] = 0.0
    _close(tgeo.depth_to_disp(_t(d), 0.1, 100.0),
           jgeo.depth_to_disp(jnp.asarray(d), 0.1, 100.0))
    s = RNG.rand(N, H, W, 1).astype(np.float32)
    for a, b in zip(tgeo.disp_to_depth(_t(s), 0.1, 100.0),
                    jgeo.disp_to_depth(jnp.asarray(s), 0.1, 100.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("invert", [False, True])
def test_pose_from_parameters(invert):
    aa = (RNG.randn(3, 1, 3) * 0.3).astype(np.float32)
    tr = (RNG.randn(3, 1, 3) * 0.5).astype(np.float32)
    _close(tgeo.transformation_from_parameters(_t(aa), _t(tr), invert),
           jgeo.transformation_from_parameters(jnp.asarray(aa),
                                               jnp.asarray(tr), invert))
    _close(tgeo.rot_from_axisangle(_t(aa)),
           jgeo.rot_from_axisangle(jnp.asarray(aa)))
    _close(tgeo.get_translation_matrix(_t(tr)),
           jgeo.get_translation_matrix(jnp.asarray(tr)))


@pytest.mark.parametrize("tx", [0.1, -0.1])
def test_backproject_and_project(tx):
    k = np.eye(4, dtype=np.float32)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * W, 1.92 * H, W / 2, H / 2
    kb = np.repeat(k[None], N, 0)
    invk = np.linalg.pinv(kb).astype(np.float32)
    t = np.repeat(np.eye(4, dtype=np.float32)[None], N, 0)
    t[:, 0, 3] = tx
    depth = RNG.rand(N, H, W, 1).astype(np.float32) * 30 + 1
    pts_t = tgeo.backproject_depth(_t(depth), _t(invk))
    pts_j = jgeo.backproject_depth(jnp.asarray(depth), jnp.asarray(invk))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), rtol=1e-5,
                               atol=1e-5)
    _close(tgeo.project_3d(pts_t, _t(kb), _t(t), H, W),
           jgeo.project_3d(pts_j, jnp.asarray(kb), jnp.asarray(t), H, W))


# --- image ops and SSIM ----------------------------------------------------

def test_ssim_pool_and_smoothness():
    x = RNG.rand(N, H, W, 3).astype(np.float32)
    y = RNG.rand(N, H, W, 3).astype(np.float32)
    _close(tssim.ssim(_t(x), _t(y)), jssim.ssim(jnp.asarray(x),
                                                jnp.asarray(y)))
    _close(timage.avg_pool3_valid(_t(x)),
           jimage.avg_pool3_valid(jnp.asarray(x)))
    disp = RNG.rand(N, H, W, 1).astype(np.float32)
    _close(timage.get_smooth_loss(_t(disp), _t(x), 2.0),
           jimage.get_smooth_loss(jnp.asarray(disp), jnp.asarray(x), 2.0))
    _close(timage.normalize_image(_t(disp)),
           jimage.normalize_image(jnp.asarray(disp)))


@pytest.mark.parametrize("reduce", [False, True])
def test_grad_map(reduce):
    x = RNG.rand(N, 9, 11, 3).astype(np.float32)
    _close(timage.get_grad_map(_t(x), reduce),
           jimage.get_grad_map(jnp.asarray(x), reduce))


# --- augmentation ----------------------------------------------------------

def test_color_jitter_per_item_and_scalar():
    img = RNG.rand(N, H, W, 3).astype(np.float32)
    p = np.array([[1.1, 0.9, 1.15, 0.07], [0.85, 1.2, 0.8, -0.09]],
                 np.float32)
    per = [p[:, i][:, None, None, None] for i in range(4)]
    jitter = jax.jit(lambda *a: jaug.color_jitter(*a, xp=jnp))
    _close(taug.color_jitter(_t(img), *[_t(a) for a in per]),
           jitter(jnp.asarray(img), *per))
    _close(taug.color_jitter(_t(img[0]), 1.1, 0.9, 1.15, 0.07),
           jitter(jnp.asarray(img[0]), 1.1, 0.9, 1.15, 0.07))


def test_expand_batch_uint8_feed():
    batch = {("color_u8", "0", 0): RNG.randint(0, 256, (N, H, W, 3),
                                               dtype=np.uint8),
             ("color_u8", "s", 0): RNG.randint(0, 256, (N, H, W, 3),
                                               dtype=np.uint8),
             ("color_u8", "0", 1): RNG.randint(0, 256, (N, H // 2, W // 2,
                                                        3), dtype=np.uint8),
             ("jitter",): np.array([[1.1, 0.9, 1.15, 0.07],
                                    [1.0, 1.0, 1.0, 0.0]], np.float32),
             ("K", 0): np.eye(4, dtype=np.float32)[None].repeat(N, 0)}
    ours = taug.expand_batch({k: _t(v) for k, v in batch.items()})
    ref = jax.jit(lambda b: jaug.expand_batch(b, jnp))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k])
    floats = {k: _t(v) for k, v in ref.items()}
    assert taug.expand_batch(floats) is floats


# --- losses ----------------------------------------------------------------

def test_reprojection_loss_and_masks():
    a = RNG.rand(N, H, W, 3).astype(np.float32)
    b = RNG.rand(N, H, W, 3).astype(np.float32)
    for no_ssim in (False, True):
        _close(tl.compute_reprojection_loss(_t(a), _t(b), no_ssim),
               jl.compute_reprojection_loss(jnp.asarray(a), jnp.asarray(b),
                                            no_ssim))
    r, i, h = (RNG.rand(N, H, W, 1).astype(np.float32) for _ in range(3))
    for args in ((r, i, h), (r, None, h), (r, i, None), (r, None, None)):
        ours = tl.compute_loss_masks(*[None if a is None else _t(a)
                                       for a in args])
        ref = jl.compute_loss_masks(*[None if a is None else jnp.asarray(a)
                                      for a in args])
        for o, e in zip(ours, ref):
            assert (o is None) == (e is None)
            if o is not None:
                np.testing.assert_array_equal(o.numpy(), np.asarray(e))
    v = (RNG.rand(N, H, W, 1) > 0.2).astype(np.float32)
    _close(tl.compute_proxy_supervised_loss(_t(r), _t(h), _t(v), _t(i)),
           jl.compute_proxy_supervised_loss(*map(jnp.asarray, (r, h, v, i))))


def test_use_banded_warp():
    o = TOptions(width=640)
    assert not tl.use_banded_warp(o)                   # "auto": gather
    for v, want in (("on", True), ("off", False), (True, True),
                    (False, False)):
        assert tl.use_banded_warp(dataclasses.replace(
            o, stereo_warp_kernel=v)) is want
    with pytest.raises(ValueError):
        tl.use_banded_warp(dataclasses.replace(o, stereo_warp_kernel="x"))


def _scene_inputs(seed=0):
    """A stereo batch (item 0 right-of-left, item 1 flipped: +-0.1) with
    hints, colours at every scale, intrinsics per scale."""
    rs = np.random.RandomState(seed)
    inputs = {}
    for s in range(4):
        h, w = H // 2 ** s, W // 2 ** s
        for fid in ("0", "s"):
            inputs[("color", fid, s)] = rs.rand(N, h, w, 3).astype(
                np.float32)
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
        inputs[("K", s)] = np.repeat(k[None], N, 0)
        inputs[("inv_K", s)] = np.linalg.pinv(inputs[("K", s)]).astype(
            np.float32)
    t = np.repeat(np.eye(4, dtype=np.float32)[None], N, 0)
    t[:, 0, 3] = (0.1, -0.1)
    inputs[("stereo_T",)] = t
    depth = (rs.rand(N, H, W, 1) * 20 + 2).astype(np.float32)
    depth[:, ::7, ::5] = 0.0
    inputs[("depth_hint",)] = depth
    inputs[("depth_hint_mask",)] = (depth > 0).astype(np.float32)
    inputs[("disp_hint",)] = np.asarray(jgeo.depth_to_disp(
        jnp.asarray(depth), 0.1, 100.0))
    outputs = {("disp", s): rs.uniform(0.02, 0.3, (N, H // 2 ** s,
                                                   W // 2 ** s, 1))
               .astype(np.float32) for s in range(4)}
    return inputs, outputs


def _jax_noise(rng, shape, scales=(0, 1, 2, 3)):
    """The draws compute_losses_* make, keyed by scale."""
    out = {}
    for s in scales:
        rng, sub = jax.random.split(rng)
        out[s] = _t(jax.random.normal(sub, shape, jnp.float32))
    return out


def _losses_both(kw, hints):
    fields = dict(use_stereo=True, frame_ids=(0,), use_wavelets=True,
                  use_depth_hints=hints, height=H, width=W, batch_size=N,
                  **kw)
    jo, to = JOptions(**fields), TOptions(**fields)
    inputs, outputs = _scene_inputs()
    rng = jax.random.PRNGKey(3)
    jfn = jl.compute_losses_hints if hints else jl.compute_losses_mdp
    tfn = tl.compute_losses_hints if hints else tl.compute_losses_mdp

    @jax.jit
    def ref_fn(ins, outs, r):
        outs = jl.generate_images_pred(ins, dict(outs), jo)
        return jfn(ins, outs, jo, r), outs

    ref, ref_out = ref_fn({k: jnp.asarray(v) for k, v in inputs.items()},
                          {k: jnp.asarray(v) for k, v in outputs.items()},
                          rng)
    tin = {k: _t(v) for k, v in inputs.items()}
    tout = tl.generate_images_pred(tin, {k: _t(v) for k, v in
                                         outputs.items()}, to)
    ours = tfn(tin, tout, to, _jax_noise(rng, (N, H, W, 1)))
    return ours, ref, tout, ref_out


@pytest.mark.parametrize("kern", ["on", "off"])
def test_losses_hints_match_jax(kern):
    ours, ref, tout, ref_out = _losses_both(
        dict(stereo_warp_kernel=kern, hint_disp_l1_weight=0.5), True)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    # warped images within 1e-4: the x2-x8 bilinear upsampling of disp
    # rounds differently in jax.image.resize and F.interpolate, and
    # depth = 1 / disp moves the sample by up to ~1e-4 px
    for k in (("color", "s", 0), ("color", "s", 3),
              ("color_depth_hint", "s", 0)):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(ref_out[k]),
                                   rtol=0, atol=1e-4, err_msg=str(k))
    np.testing.assert_allclose(tout[("depth", 0, 2)].numpy(),
                               np.asarray(ref_out[("depth", 0, 2)]),
                               rtol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"avg_reprojection": True,
                                     "no_ssim": True},
                                {"disable_automasking": True}])
def test_losses_mdp_match_jax(kw):
    ours, ref, _, _ = _losses_both(kw, False)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


def test_pose_frames_raise():
    """The pose-frame warps, which raised before the pose nets were
    ported: M+S (frames 0, -1, 1 and s) with the pose net's cam_T_cam,
    generate_images_pred and compute_losses_mdp against JAX's."""
    fields = dict(use_stereo=True, frame_ids=(0, -1, 1), use_wavelets=True,
                  height=H, width=W, batch_size=N)
    jo, to = JOptions(**fields), TOptions(**fields)
    inputs, outputs = _scene_inputs()
    rs = np.random.RandomState(5)
    for fid in ("-1", "1"):
        # smoothed, as camera images are: the pose warps rotate, so float32
        # rounding of a sample position differs more than in the
        # row-banded stereo warp, and a smooth texture keeps its effect
        # on the colour below it
        tex = rs.rand(N, H, W, 3)
        for _ in range(2):
            tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 2)) / 3.0
        inputs[("color", fid, 0)] = tex.astype(np.float32)
    aa = (0.02 * rs.randn(2, N, 1, 1, 3)).astype(np.float32)
    tr = (0.3 * rs.randn(2, N, 1, 1, 3)).astype(np.float32)

    def pose_T(geo, asarray):
        out = {}
        for i, f_i in enumerate((-1, 1)):
            out[("cam_T_cam", 0, f_i)] = geo.transformation_from_parameters(
                asarray(aa[i])[:, 0], asarray(tr[i])[:, 0], invert=f_i < 0)
        return out

    rng = jax.random.PRNGKey(3)

    @jax.jit
    def ref_fn(ins, outs, r):
        pose = pose_T(jgeo, jnp.asarray)
        outs = jl.generate_images_pred(ins, dict(outs), jo, pose)
        return jl.compute_losses_mdp(ins, outs, jo, r), outs

    ref, ref_out = ref_fn({k: jnp.asarray(v) for k, v in inputs.items()},
                          {k: jnp.asarray(v) for k, v in outputs.items()},
                          rng)
    tin = {k: _t(v) for k, v in inputs.items()}
    tout = tl.generate_images_pred(tin, {k: _t(v) for k, v in
                                         outputs.items()}, to,
                                   pose_T(tgeo, _t))
    ours = tl.compute_losses_mdp(tin, tout, to,
                                 _jax_noise(rng, (N, H, W, 3)))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    # warped images within 1e-4, as test_losses_hints_match_jax
    for fid in ("-1", "1", "s"):
        for s in (0, 3):
            k = ("color", fid, s)
            np.testing.assert_allclose(tout[k].numpy(),
                                       np.asarray(ref_out[k]), rtol=0,
                                       atol=1e-4, err_msg=str(k))
