"""Port parity, the fused wave stage (K2): wavelet_monodepth_tpu_torch's
ops/fused_stage.py against the JAX Pallas kernel `fused_wave_stage`, run
in interpret mode as tests/test_pallas_fused.py runs it.

On the CPU the port's wrapper runs its plain PyTorch version, so these
tests hold that version, the padding, the tile flags and the phase
interleave to JAX within 1e-5 over the whole tensors, the image-border
ring included (XLA-CPU and ATen sum the convs in different orders). The
CUDA kernel is checked against the plain version by the `cuda`-marked
test at the end (and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.ops.pallas_fused import \
    fused_wave_stage as j_fused
from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
from wavelet_monodepth_tpu_torch.ops.wavelets import haar_idwt

torch.set_num_threads(1)
ATOL = 1e-5


def _setup(n=1, hl=16, wl=128, cx=16, cs=8, cd=16, seed=0):
    """tests/test_pallas_fused.py's case: x, skip, yl and the 12 params
    (HWIO) from a numpy seed."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hl, wl, cx).astype(np.float32)
    skip = rng.randn(n, 2 * hl, 2 * wl, cs).astype(np.float32)
    yl = rng.randn(n, 2 * hl, 2 * wl, 1).astype(np.float32)
    shapes = [(3, 3, cx, cd), (cd,), (3, 3, cd + cs, cd), (cd,),
              (1, 1, cd, cd), (cd,), (3, 3, cd, 3), (3,),
              (1, 1, cd, cd), (cd,), (3, 3, cd, 3), (3,)]
    params = [(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes]
    return x, skip, yl, params


def _port(arrays, mask, i_scale=2, **kw):
    x, skip, yl, params = arrays
    t = torch.from_numpy
    return fs.fused_wave_stage(t(x), t(skip), t(yl), t(mask),
                               *[t(p) for p in params], i_scale=i_scale, **kw)


@pytest.mark.parametrize("n,hl,wl,density,seed", [
    (1, 16, 128, 0.2, 0),      # test_pallas_fused.py's shapes
    (2, 10, 40, 0.15, 1)])     # batched, ragged in both tile dims
def test_fused_stage_matches_jax(n, hl, wl, density, seed):
    arrays = _setup(n=n, hl=hl, wl=wl, seed=seed)
    rng = np.random.RandomState(seed + 10)
    mask = (rng.rand(n, hl, wl, 1) < density).astype(np.float32)
    mask[0, :, : wl // 4] = 0.0         # whole inactive tiles too
    ours = _port(arrays, mask)
    x, skip, yl, params = arrays
    ref = j_fused(jnp.asarray(x), jnp.asarray(skip), jnp.asarray(yl),
                  jnp.asarray(mask), *[jnp.asarray(p) for p in params],
                  i_scale=2, interpret=True)
    for name, o, r in zip(("yh", "yl_new", "x1"), ours, ref):
        assert tuple(o.shape) == r.shape, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   err_msg=name)


def test_inactive_tiles_are_the_yl_butterfly():
    """An all-zero mask flags every tile off: yh and x1 are exact zeros and
    yl_new is exactly the IDWT of yl alone."""
    arrays = _setup(n=2, hl=8, wl=64, seed=4)
    mask = np.zeros((2, 8, 64, 1), np.float32)
    yh, yl_new, x1 = _port(arrays, mask)
    assert not yh.any() and not x1.any()
    yl = torch.from_numpy(arrays[2])
    zero = torch.zeros_like(yl)
    assert torch.equal(yl_new, haar_idwt(yl, zero, zero, zero))


def test_tile_flags_follow_the_upconv1_halo_window():
    """A tile is on when the zero-padded upconv1 mask has a pixel inside
    its (ht+2) x (tw+2) window, halo included."""
    x, skip, yl, _ = _setup(n=1, hl=8, wl=64, cx=2, cs=2, cd=4)
    mask = np.zeros((1, 8, 64, 1), np.float32)
    mask[0, 1, 31] = 1.0     # upconv1 mask at rows 1..4, cols 61..64
    inp = fs._stage_inputs(torch.from_numpy(x), torch.from_numpy(skip),
                           torch.from_numpy(yl), torch.from_numpy(mask),
                           8, 64)
    assert inp["flags"].dtype == torch.int32
    np.testing.assert_array_equal(inp["flags"].numpy(),
                                  [[[1, 1], [0, 0]]])


def test_cpu_path_counts_no_launch():
    fs.reset_launches()
    arrays = _setup(n=1, hl=4, wl=32, cx=4, cs=4, cd=4)
    _port(arrays, np.ones((1, 4, 32, 1), np.float32))
    assert fs.launches == {"fused_wave_stage": 0}


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 16, 128, 16, 8, 16),
                                   (2, 12, 40, 256, 128, 128),
                                   (2, 10, 36, 64, 64, 32),
                                   (2, 24, 80, 128, 64, 64),    # scale 2
                                   (2, 48, 160, 64, 64, 32),    # scale 1
                                   (1, 8, 64, 16, 8, 12),   # a partial n8
                                   (2, 12, 40, 20, 8, 16),  # partial chunk
                                   (1, 10, 36, 10, 6, 8)])  # 4-byte copies
def test_kernel_matches_plain_on_card(cuda_device, shape):
    n, hl, wl, cx, cs, cd = shape
    x, skip, yl, params = _setup(n, hl, wl, cx, cs, cd, seed=sum(shape))
    # weights at the fan-in scale of the net's init, so that sums of up to
    # 9 * 384 terms stay O(1) and 1e-4 measures the summation order
    params = [(p * min(1.0, (16.0 / np.prod(p.shape[:-1])) ** 0.5)
               ).astype(np.float32) for p in params]
    rng = np.random.RandomState(5)
    t = (lambda a: torch.from_numpy(a).to(cuda_device))
    before = fs.launches["fused_wave_stage"]
    for density in (0.0, 0.1, 1.0):
        mask = (rng.rand(n, hl, wl, 1) < density).astype(np.float32)
        args = (t(x), t(skip), t(yl), t(mask), *[t(p) for p in params])
        ours = fs.fused_wave_stage(*args, i_scale=2)
        inp = fs._stage_inputs(*args[:4], 8, 64)
        yh, ph, x1 = fs.fused_wave_stage_plain(inp, args[4:], 2, 8, 64)
        torch.cuda.synchronize()
        assert float((ours[0] - yh[:, :2 * hl, :2 * wl]).abs().max()) <= 1e-4
        assert float((ours[2] - x1[:, :2 * hl, :2 * wl]).abs().max()) <= 1e-4
    assert fs.launches["fused_wave_stage"] == before + 3
