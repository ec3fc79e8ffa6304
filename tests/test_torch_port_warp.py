"""Port parity, the banded stereo warp (K3): wavelet_monodepth_tpu_torch's
ops/warp.py against the JAX Pallas kernel `grid_sample_border_banded`,
run in interpret mode on the CPU as tests/test_warp.py runs it, and the
port's `F.grid_sample` sampler against the JAX gather.

On the CPU the port's wrapper runs its plain PyTorch version, so these
tests hold that version (forward, and the gradients for the image and
the grid) to JAX: forward within 1e-5, gradients within 1e-5 of the
largest gradient (float32 sums in another order). The CUDA kernel is
held to the plain version by the `cuda`-marked tests at the end (and by
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.ops.geometry import backproject_depth, project_3d
from wavelet_monodepth_tpu.ops.image import grid_sample_border as j_gather
from wavelet_monodepth_tpu.ops.warp import grid_sample_border_banded as j_band
from wavelet_monodepth_tpu_torch.ops import image as timage
from wavelet_monodepth_tpu_torch.ops import warp

torch.set_num_threads(1)
H, W = 64, 96


def _stereo(n=2, h=H, w=W, tx=0.1, seed=0, near=1.0, c=3):
    """A row-banded stereo grid from random depth, and a C-channel
    image."""
    rng = np.random.RandomState(seed)
    k = np.eye(4, dtype=np.float32)
    k[0, 0], k[1, 1] = 0.58 * w, 1.92 * h
    k[0, 2], k[1, 2] = 0.5 * w, 0.5 * h
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = tx
    kb = jnp.asarray(np.repeat(k[None], n, 0))
    invkb = jnp.asarray(np.repeat(np.linalg.pinv(k)[None], n, 0))
    tb = jnp.asarray(np.repeat(t[None], n, 0))
    depth = jnp.asarray(rng.rand(n, h, w, 1).astype(np.float32) * 30 + near)
    grid = np.asarray(project_3d(backproject_depth(depth, invkb), kb, tb,
                                 h, w))
    img = rng.rand(n, h, w, c).astype(np.float32)
    return img, np.array(grid)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@jax.jit
def _jax_vjp_jit(img, grid, g):
    out, vjp = jax.vjp(j_band, img, grid)
    return (out,) + vjp(g)


def _jax_vjp(img, grid, g):
    return tuple(np.asarray(a) for a in _jax_vjp_jit(
        jnp.asarray(img), jnp.asarray(grid), jnp.asarray(g)))


def _port_grads(img, grid, g, fn=warp.grid_sample_border_banded):
    ti = torch.from_numpy(img).requires_grad_()
    tg = torch.from_numpy(grid).requires_grad_()
    out = fn(ti, tg)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), ti.grad.numpy(), tg.grad.numpy()


@pytest.mark.parametrize("tx", [0.1, -0.1])
def test_plain_matches_jax_forward_and_grads(tx):
    img, grid = _stereo(tx=tx, seed=1)
    g = np.random.RandomState(2).randn(*img.shape).astype(np.float32)
    ref, gi_r, gg_r = _jax_vjp(img, grid, g)
    ours, gi, gg = _port_grads(img, grid, g)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    assert _rel(gi, gi_r) <= 1e-5
    assert _rel(gg, gg_r) <= 1e-5


def test_y_gradient_reaches_column_zero_only():
    """y is read per row at column 0, so only grid[:, :, 0, 1] gets a y
    gradient, as in the JAX kernel (not F.grid_sample's per-pixel y)."""
    img, grid = _stereo(seed=3)
    g = np.random.RandomState(4).randn(*img.shape).astype(np.float32)
    _, _, gg = _port_grads(img, grid, g)
    _, _, gg_r = _jax_vjp(img, grid, g)
    assert np.abs(gg[:, :, 1:, 1]).max() == 0.0
    assert np.abs(gg[:, :, 0, 1]).max() > 0.0
    np.testing.assert_array_equal(gg_r[:, :, 1:, 1], 0.0)


def test_border_clamp():
    """Coordinates far outside clamp to the border (padding_mode='border')
    and carry no gradient."""
    rng = np.random.RandomState(5)
    img = rng.rand(2, H, W, 3).astype(np.float32)
    u = np.full((2, H, W), 3.0, np.float32)
    u[1, :, : W // 2] = -2.5
    rows = (np.arange(H, dtype=np.float32) + 0.5) / H * 2.0 - 1.0
    v = np.broadcast_to(rows[None, :, None], (2, H, W))
    grid = np.ascontiguousarray(np.stack([u, v], -1))
    g = rng.randn(*img.shape).astype(np.float32)
    ref, gi_r, gg_r = _jax_vjp(img, grid, g)
    ours, gi, gg = _port_grads(img, grid, g)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, np.asarray(j_gather(
        jnp.asarray(img), jnp.asarray(grid))), atol=1e-5, rtol=0)
    assert np.abs(gg[..., 0]).max() == 0.0
    assert _rel(gi, gi_r) <= 1e-5


@pytest.mark.parametrize("h,w", [(2, 70), (3, 96)])
def test_ragged_shapes(h, w):
    img, grid = _stereo(n=2, h=h, w=w, seed=h * w)
    g = np.random.RandomState(6).randn(*img.shape).astype(np.float32)
    ref, gi_r, gg_r = _jax_vjp(img, grid, g)
    ours, gi, gg = _port_grads(img, grid, g)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    assert _rel(gi, gi_r) <= 1e-5
    assert _rel(gg, gg_r) <= 1e-5


# the forward kernel's edge shapes: H not a multiple of its band of rows,
# W not a multiple of 4 (nor of a warp's 128 pixels), C in {1, 3, 4}
EDGE = [(13, 70, 1), (13, 70, 3), (13, 70, 4), (7, 97, 3), (5, 100, 4)]


@pytest.mark.parametrize("h,w,c", EDGE)
def test_edge_shapes_match_jax(h, w, c):
    img, grid = _stereo(n=2, h=h, w=w, seed=h + w + c, c=c)
    g = np.random.RandomState(c).randn(*img.shape).astype(np.float32)
    ref, gi_r, gg_r = _jax_vjp(img, grid, g)
    ours, gi, gg = _port_grads(img, grid, g)
    assert ours.shape == (2, h, w, c)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    assert _rel(gi, gi_r) <= 1e-5
    assert _rel(gg, gg_r) <= 1e-5


def test_matches_gather_on_stereo_grids():
    """On a row-banded grid the banded warp equals F.grid_sample up to the
    per-pixel y noise of a row (~1e-6 px), within tests/test_warp.py's
    1e-4."""
    img, grid = _stereo(seed=7, tx=-0.1)
    a = warp.grid_sample_border_banded(torch.from_numpy(img),
                                       torch.from_numpy(grid))
    b = timage.grid_sample_border(torch.from_numpy(img),
                                  torch.from_numpy(grid))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


def test_grid_sample_border_matches_jax_gather():
    """The "auto"/"off" sampler: forward and grads vs the JAX gather."""
    rng = np.random.RandomState(8)
    img = rng.rand(2, 7, 9, 3).astype(np.float32)
    grid = (rng.rand(2, 5, 6, 2).astype(np.float32) * 2.4 - 1.2)
    g = rng.randn(2, 5, 6, 3).astype(np.float32)
    out, vjp = jax.vjp(j_gather, jnp.asarray(img), jnp.asarray(grid))
    gi_r, gg_r = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    ours, gi, gg = _port_grads(img, grid, g, timage.grid_sample_border)
    np.testing.assert_allclose(ours, np.asarray(out), atol=1e-5, rtol=0)
    assert _rel(gi, gi_r) <= 1e-5
    assert _rel(gg, gg_r) <= 1e-5


def test_cpu_path_counts_no_launch_and_checks_shapes():
    img, grid = _stereo(seed=9)
    before = dict(warp.launches)
    warp.grid_sample_border_banded(torch.from_numpy(img),
                                   torch.from_numpy(grid))
    assert warp.launches == before
    with pytest.raises(ValueError, match="own grid"):
        warp.grid_sample_border_banded(torch.from_numpy(img),
                                       torch.from_numpy(grid[:, :, :-1]))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        warp.banded_warp(torch.zeros(1, 2, 4, 3, device="meta"),
                         torch.zeros(1, 2, 4), torch.zeros(1, 2))


@pytest.mark.parametrize("n,h,w,want", [(6, 320, 1024, 1), (6, 320, 1242, 1),
                                        (1, 375, 1242, 1), (12, 192, 640, 6)])
def test_band_rows_and_backward_fit_at_high_resolution(n, h, w, want):
    """K3's launch sizing for an H100's 132 SMs (C = 3), at the 1024x320
    B=6 training cell, at raw KITTI width and at the 640x192 B=12 cell:
    the fewest rows whose grid fits one wave at >= 2 blocks per SM, else
    1 row; the forward's band fits a block's shared memory, and so does
    the backward's source-row accumulator (W * C floats)."""
    src = torch.empty(n, h, w, 3, device="meta")
    rows = warp.band_rows(src, sms=132)
    assert rows == want
    assert warp.fwd_smem_bytes(rows, w, 3) <= warp._SMEM_LIMIT
    fits = [r for r in range(1, h + 1)
            if warp.fwd_smem_bytes(r, w, 3) <= warp._SMEM_LIMIT
            and warp.blocks_per_sm(r, w, 3) >= 2
            and n * -(-h // r) <= 132 * warp.blocks_per_sm(r, w, 3)]
    assert rows == (min(fits) if fits else 1)
    assert warp.bwd_smem_bytes(w, 3, True) == 4 * w * 3 <= warp._SMEM_LIMIT
    assert warp.bwd_smem_bytes(w, 3, False) == 0


def test_plain_matches_jax_at_1024x320():
    """The plain version against JAX's banded warp (interpret mode) on a
    (1, 320, 1024, 3) image, the 1024x320 training cell's width: forward
    within 1e-5, gradients within 1e-5 of the largest."""
    img, grid = _stereo(n=1, h=320, w=1024, seed=3)
    g = np.random.RandomState(4).randn(*img.shape).astype(np.float32)
    ref, gi_r, gg_r = _jax_vjp(img, grid, g)
    ours, gi, gg = _port_grads(img, grid, g)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    assert _rel(gi, gi_r) <= 1e-5
    assert _rel(gg, gg_r) <= 1e-5


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _on(dev, a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev) \
        .requires_grad_(grad)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 96), (2, 3, 70), (1, 2, 96)])
@pytest.mark.parametrize("with_src", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, shape, with_src):
    n, h, w = shape
    img, grid = _stereo(n=n, h=h, w=w, seed=h + w)
    g = torch.from_numpy(np.random.RandomState(1).randn(
        *img.shape).astype(np.float32)).to(cuda_device)
    x, yr = warp.banded_coords(_on(cuda_device, grid), h, w)
    res = {}
    for name, fn in (("kernel", warp.BandedWarp.apply),
                     ("plain", warp.banded_warp_plain)):
        src = _on(cuda_device, img, with_src)
        xa, ya = x.clone().requires_grad_(), yr.clone().requires_grad_()
        out = fn(src, xa, ya)
        out.backward(g)
        res[name] = (out.detach(), src.grad, xa.grad, ya.grad)
    torch.cuda.synchronize()
    assert float((res["kernel"][0] - res["plain"][0]).abs().max()) <= 1e-5
    for a, b in zip(res["kernel"][1:], res["plain"][1:]):
        if b is None:
            assert a is None
            continue
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_counts_and_rejects_bf16_on_card(cuda_device):
    img, grid = _stereo(seed=2)
    before = dict(warp.launches)
    tg = _on(cuda_device, grid, True)
    out = warp.grid_sample_border_banded(_on(cuda_device, img), tg)
    out.sum().backward()
    torch.cuda.synchronize()
    assert warp.launches["banded_warp_fwd"] == before["banded_warp_fwd"] + 1
    assert warp.launches["banded_warp_bwd"] == before["banded_warp_bwd"] + 1
    x, yr = warp.banded_coords(tg.detach(), H, W)
    with pytest.raises(TypeError, match="float32"):
        warp.banded_warp(_on(cuda_device, img).bfloat16(), x, yr)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", EDGE + [(5, 300, 4), (13, 70, 5),
                                   (24, 640, 3)])
@pytest.mark.parametrize("rows", [None, 1, 3, 5])
def test_forward_bands_match_plain_on_card(cuda_device, h, w, c, rows):
    """The forward kernel against the plain version for bands of 1, 3 and
    5 rows and band_rows' own choice, at H not a multiple of the band, W
    not a multiple of 4 or of a warp's 128 pixels, C in {1, 3, 4} (staged
    16-byte stores where W * C % 4 == 0) and C = 5 (the any-C path);
    within 1e-5."""
    img, grid = _stereo(n=2, h=h, w=w, seed=h * w + c, c=c)
    src = _on(cuda_device, img)
    x, yr = warp.banded_coords(_on(cuda_device, grid), h, w)
    before = warp.launches["banded_warp_fwd"]
    out = warp._launch_fwd(src, x, yr, rows)
    ref = warp.banded_warp_plain(src, x, yr)
    torch.cuda.synchronize()
    assert warp.launches["banded_warp_fwd"] == before + 1
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_band_rows_fill_the_card_and_raise_when_too_wide(cuda_device):
    src = torch.zeros(12, 192, 640, 3, device=cuda_device)
    rows = warp.band_rows(src)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert 1 <= rows <= 192
    assert 12 * -(-192 // rows) >= sms       # the grid fills the card
    with pytest.raises(ValueError, match="shared memory"):
        warp.band_rows(torch.zeros(1, 4, 20000, 4, device=cuda_device))
