"""Port parity, the compacted sparse-decoder backends: the KITTI wavelet
decoder of wavelet_monodepth_tpu_torch on use_pallas = "compact",
"sites" and "capacity" against the JAX decoder (Pallas in interpret
mode), and the site and capacity engines' primitives, at 64x96 (the
pattern of test_torch_port_models.py).

Tolerances: disparity and wavelets within 1e-5 absolute plus 1e-5
relative (XLA-CPU and ATen sum convs and GEMMs in different orders; LL
values reach 2^4); masks, op counts and ("overflow", s) exactly, with
masks prescribed by `mask_override`; gathers and scatters bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.ops import capacity as jcap
from wavelet_monodepth_tpu.ops import sites as jst
from wavelet_monodepth_tpu.ops.image import pad2d as jpad2d
from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
    KittiWaveletDecoder
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.ops import blockio as bio
from wavelet_monodepth_tpu_torch.ops import capacity as cap
from wavelet_monodepth_tpu_torch.ops import sites as st
from wavelet_monodepth_tpu_torch.ops.image import pad2d
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.utils import maskgen as tmg

torch.set_num_threads(1)
H, W, N = 64, 96, 2


@pytest.fixture(scope="module")
def models():
    """The JAX encoder's features of 2 random images, the JAX decoder's
    variables, and the port decoder holding the same weights."""
    img = np.random.RandomState(0).rand(N, H, W, 3).astype(np.float32)
    enc = JEncoder(num_layers=18)
    ev = enc.init(jax.random.PRNGKey(0), jnp.asarray(img[:1]))
    feats = enc.apply(ev, jnp.asarray(img))
    jdec = JDecoder(num_ch_enc=j_num_ch_enc(18))
    dv = jdec.init(jax.random.PRNGKey(1), feats)
    tenc = ResnetEncoder(18)
    tdec = KittiWaveletDecoder(tenc.num_ch_enc).eval()
    ti.load_state_dicts(tenc, tdec, *ti.state_dicts_from_jax(ev, dv))
    disp = tmg.synthetic_depth_scene(N, H, W, seed=3)
    masks, _, _ = tmg.masks_at_density(disp, 0.10)
    return {"jdec": jdec, "dv": dv, "feats": [np.array(f) for f in feats],
            "tdec": tdec, "masks": masks}


def _assert_outputs(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        o = ours[k].numpy()
        if k[0].endswith("mask") or k[0] in ("total_ops", "overflow"):
            np.testing.assert_array_equal(o, np.asarray(v), err_msg=str(k))
        else:
            np.testing.assert_allclose(o, np.asarray(v), atol=1e-5,
                                       rtol=1e-5, err_msg=str(k))


@pytest.mark.parametrize("compact_cap", [1.0, 0.5])
@pytest.mark.parametrize("backend", ["compact", "sites", "capacity"])
def test_decoder_backends_match_jax(models, backend, compact_cap):
    """The whole sparse decode at the maskgen 10% edge masks: outputs,
    masks, op counts and per-scale overflow equal JAX's; at cap 0.5 the
    tile backends drop tiles, and the survivors must be JAX's."""
    ref = models["jdec"].apply(
        models["dv"], [jnp.asarray(f) for f in models["feats"]],
        thresh_ratio=0.1, use_pallas=backend, compact_cap=compact_cap,
        mask_override={i: jnp.asarray(m) for i, m in models["masks"].items()})
    with torch.no_grad():
        ours = models["tdec"](
            [torch.from_numpy(f) for f in models["feats"]], thresh_ratio=0.1,
            use_pallas=backend, compact_cap=compact_cap,
            mask_override={i: torch.from_numpy(m)
                           for i, m in models["masks"].items()})
    _assert_outputs(ours, ref)
    if compact_cap == 1.0:
        assert all(int(ours[("overflow", s)]) == 0 for s in range(3))


def test_cpu_compact_forward_launches_no_kernel(models):
    bio.reset_launches()
    with torch.no_grad():
        models["tdec"]([torch.from_numpy(f) for f in models["feats"]],
                       thresh_ratio=0.1, use_pallas="compact")
    assert bio.launches == {"band_gather": 0, "block_scatter": 0}


def test_site_primitives_match_jax():
    """site_list (with sites past capacity dropped), site_overflow, and
    the sentinel semantics of gather_patches (clamped start) and
    scatter_rows (dropped row) equal JAX's exactly."""
    rng = np.random.RandomState(2)
    n, h, w, c = 2, 6, 10, 5
    mask = (rng.rand(n, h, w, 1) > 0.6).astype(np.float32)
    active = int(mask.sum())
    x = rng.randn(n, h, w, c).astype(np.float32)
    xp_t = pad2d(torch.from_numpy(x), 1, "reflect")
    xp_j = jpad2d(jnp.asarray(x), 1, "reflect")
    for kcap in (active - 5, active + 7):
        s_t = st.site_list(torch.from_numpy(mask), kcap)
        s_j = jst.site_list(jnp.asarray(mask), kcap)
        assert s_t.dtype == torch.int32
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        assert (int(st.site_overflow(torch.from_numpy(mask), kcap))
                == int(jst.site_overflow(jnp.asarray(mask), kcap)))
        p_t = st.gather_patches(xp_t, s_t, h, w)
        p_j = jst.gather_patches(xp_j, s_j, h, w)
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
        rows = rng.randn(kcap, 3).astype(np.float32)
        np.testing.assert_array_equal(
            st.scatter_rows(torch.from_numpy(rows), s_t, n, h, w).numpy(),
            np.asarray(jst.scatter_rows(jnp.asarray(rows), s_j, n, h, w)))


def test_site_wave_stage_overflow_matches_jax():
    """A starved site stage (every site set overflows) equals JAX's, and
    so do its overflow counts."""
    rng = np.random.RandomState(3)
    n, hl, wl, cx, cs, cd = 1, 6, 10, 8, 4, 8
    x = rng.randn(n, hl, wl, cx).astype(np.float32)
    skip = rng.randn(n, 2 * hl, 2 * wl, cs).astype(np.float32)
    mask = (rng.rand(n, hl, wl, 1) > 0.7).astype(np.float32)
    shapes = [(3, 3, cx, cd), (cd,), (3, 3, cd + cs, cd), (cd,),
              (1, 1, cd, cd), (cd,), (3, 3, cd, 3), (3,),
              (1, 1, cd, cd), (cd,), (3, 3, cd, 3), (3,)]
    prm = [(rng.randn(*s) * 0.2).astype(np.float32) for s in shapes]
    caps = {"cap_lo": 0.2, "cap_hi": 0.15, "cap_wav": 0.05}
    ours = st.site_wave_stage(torch.from_numpy(x), torch.from_numpy(skip),
                              torch.from_numpy(mask),
                              *[torch.from_numpy(p) for p in prm],
                              i_scale=2, **caps)
    ref = jst.site_wave_stage(jnp.asarray(x), jnp.asarray(skip),
                              jnp.asarray(mask),
                              *[jnp.asarray(p) for p in prm], i_scale=2,
                              **caps)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)
    over = int(st.stage_site_overflow(torch.from_numpy(mask), **caps))
    assert over == int(jst.stage_site_overflow(jnp.asarray(mask), **caps))
    assert over > 0


@pytest.mark.parametrize("pad_mode,ratio", [("reflect", 1.0),
                                            ("zero", 0.25),
                                            ("reflect", 0.1)])
def test_capacity_conv_matches_jax(pad_mode, ratio):
    """conv3x3_capacity_sparse with its ELU epilogue, under capacity and
    starved (clustered masks with equal tile scores, so the tie order
    decides which tiles survive), and its overflow counts."""
    rng = np.random.RandomState(4)
    n, h, w, cin, cout = 2, 40, 150, 6, 5
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    mask = np.zeros((n, h, w, 1), np.float32)
    for i in range(n):
        for _ in range(5):
            y0, x0 = rng.randint(h - 6), rng.randint(w - 6)
            mask[i, y0:y0 + 4, x0:x0 + 4] = 1.0
    mask[1, :16, :64] = 1.0
    mask[1, 16:32, 64:128] = 1.0
    ours = cap.conv3x3_capacity_sparse(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
        torch.from_numpy(mask), pad_mode, torch.nn.functional.elu,
        capacity_ratio=ratio)
    ref = jcap.conv3x3_capacity_sparse(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), jnp.asarray(mask),
        pad_mode, jax.nn.elu, capacity_ratio=ratio)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    over = cap.conv_capacity_overflow(torch.from_numpy(mask),
                                      capacity_ratio=ratio)
    assert int(over) == int(jcap.conv_capacity_overflow(
        jnp.asarray(mask), capacity_ratio=ratio))
    np.testing.assert_array_equal(
        cap.tile_overflow(torch.from_numpy(mask), 16, 64, 2).numpy(),
        np.asarray(jcap.tile_overflow(jnp.asarray(mask), 16, 64, 2)))
