"""Port parity, tile-sparse 3x3 conv: wavelet_monodepth_tpu_torch's
ops/tile_sparse_conv.py against the JAX Pallas kernels K1
(`conv3x3_tile_sparse`) and K4 (`conv3x3_tile_sparse_2d`), run as
tests/test_pallas_conv.py runs them (interpret mode on the CPU).

On the CPU the port's wrappers run their plain PyTorch version, so these
tests hold that version, the flags and the wrappers' shape handling to
JAX within 1e-5. The CUDA kernel computes in 3xTF32 on the tensor cores;
a numpy emulation of that arithmetic is held here to the kernel's 1e-4
contract at the decoder's channel counts. The CUDA kernel itself is
checked against the plain version by the `cuda`-marked tests at the end
(and by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.ops import pallas_conv as pc
from wavelet_monodepth_tpu.ops import sparse as jsp
from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc

torch.set_num_threads(1)
ATOL = 1e-5

NONLINS = {"none": (None, None), "elu": (pc.elu, tsc.elu),
           "sigmoid": (pc.sigmoid, tsc.sigmoid),
           "leaky01": (pc.leaky_relu_01, tsc.leaky_relu_01),
           "leaky02": (pc.leaky_relu_02, tsc.leaky_relu_02)}


def _data(h=16, w=256, cin=16, cout=8, seed=0, n=None):
    rng = np.random.RandomState(seed)
    lead = (h, w) if n is None else (n, h, w)
    x = rng.randn(*lead, cin).astype(np.float32)
    wgt = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, wgt, b


def _both(fn_j, fn_t, x, w, b, mask, *args, **kw):
    ref = fn_j(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
               jnp.asarray(mask), *args[0::2], interpret=True, **kw)
    ours = fn_t(torch.from_numpy(x), torch.from_numpy(w),
                torch.from_numpy(b), torch.from_numpy(mask), *args[1::2],
                **kw)
    return np.asarray(ref), ours.numpy()


def test_tile_flags():
    mask = np.zeros((16, 256, 1), np.float32)
    mask[3, 10, 0] = 1.0
    flags = tsc.tile_flags(torch.from_numpy(mask), 8, 128)
    assert flags.dtype == torch.int32 and flags.shape == (4,)
    np.testing.assert_array_equal(flags.numpy(), [1, 0, 0, 0])
    np.testing.assert_array_equal(
        flags.numpy(), np.asarray(pc.tile_flags(jnp.asarray(mask), 8, 128)))


@pytest.mark.parametrize("shape,th,tw", [((2, 20, 200, 1), 8, 64),
                                         ((3, 24, 80, 1), 8, 64),
                                         ((1, 12, 40, 1), 4, 16)])
def test_flags_equal_jax(shape, th, tw):
    m = (np.random.RandomState(1).rand(*shape) > 0.97).astype(np.float32)
    mt = torch.from_numpy(m)
    np.testing.assert_array_equal(tsc.stripe_flags(mt, th).numpy(),
                                  np.asarray(pc.stripe_flags(
                                      jnp.asarray(m), th)))
    np.testing.assert_array_equal(tsc.tile_flags_2d(mt, th, tw).numpy(),
                                  np.asarray(pc.tile_flags_2d(
                                      jnp.asarray(m), th, tw)))


@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
def test_matches_masked_dense_full_mask(pad_mode):
    x, w, b = _data()
    mask = np.ones((16, 256, 1), np.float32)
    ref, ours = _both(pc.conv3x3_tile_sparse, tsc.conv3x3_tile_sparse,
                      x, w, b, mask, pad_mode, pad_mode, jax.nn.elu, tsc.elu)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    oracle = jsp.masked_conv3x3(jnp.asarray(x)[None], jnp.asarray(w),
                                jnp.asarray(b), None, jnp.asarray(mask)[None],
                                pad_mode, jax.nn.elu)[0]
    np.testing.assert_allclose(ours, np.asarray(oracle), atol=ATOL)


def test_matches_masked_dense_partial_mask():
    x, w, b = _data(h=24, w=256, cin=8, cout=8, seed=1)
    mask = (np.random.RandomState(2).rand(24, 256, 1) > 0.8
            ).astype(np.float32)
    ref, ours = _both(pc.conv3x3_tile_sparse, tsc.conv3x3_tile_sparse,
                      x, w, b, mask, "reflect", "reflect", pc.sigmoid,
                      tsc.sigmoid)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_inactive_tiles_write_zero():
    x, w, b = _data(h=32, w=256, cin=8, cout=4, seed=3)
    mask = np.zeros((32, 256, 1), np.float32)
    mask[2:4, 5:40] = 1.0
    ref, ours = _both(pc.conv3x3_tile_sparse, tsc.conv3x3_tile_sparse,
                      x, w, b, mask, "reflect", "reflect")
    assert np.all(ours[8:] == 0.0)
    assert np.all(ours[:8, 128:] == 0.0)
    assert np.abs(ours[2:4, 5:40]).max() > 0
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_non_tile_multiple_shapes():
    x, w, b = _data(h=20, w=200, cin=8, cout=8, seed=4)
    mask = np.ones((20, 200, 1), np.float32)
    ref, ours = _both(pc.conv3x3_tile_sparse, tsc.conv3x3_tile_sparse,
                      x, w, b, mask, "reflect", "reflect")
    assert ours.shape == (20, 200, 8)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_2d_tile_sparse_matches_oracle():
    x, w, b = _data(h=24, w=200, cin=8, cout=8, seed=7)
    mask = (np.random.RandomState(8).rand(24, 200, 1) > 0.7
            ).astype(np.float32)
    ref, ours = _both(pc.conv3x3_tile_sparse_2d, tsc.conv3x3_tile_sparse_2d,
                      x, w, b, mask, "reflect", "reflect", pc.sigmoid,
                      tsc.sigmoid, th=8, tw=64)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_2d_tile_sparse_batched():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 16, 128, 8).astype(np.float32)
    w = (rng.randn(3, 3, 8, 4) * 0.1).astype(np.float32)
    b = (rng.randn(4) * 0.1).astype(np.float32)
    mask = (rng.rand(2, 16, 128, 1) > 0.5).astype(np.float32)
    ref, ours = _both(pc.conv3x3_tile_sparse_2d, tsc.conv3x3_tile_sparse_2d,
                      x, w, b, mask, "zero", "zero", th=8, tw=64)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("kernel", ["K1", "K4"])
@pytest.mark.parametrize("nonlin", list(NONLINS))
@pytest.mark.parametrize("pad_mode", ["reflect", "zero", "replicate"])
def test_pad_modes_and_nonlins(kernel, nonlin, pad_mode):
    """Every pad mode x epilogue, batched, ragged in H (20) and, for K4, in
    W (72 = 64 + 8), with a clustered mask that leaves granules empty."""
    x, w, b = _data(h=20, w=72, cin=6, cout=5, seed=13, n=2)
    mask = np.zeros((2, 20, 72, 1), np.float32)
    mask[0, 1:6, 3:30] = 1.0
    mask[1, 17:20, 66:72] = 1.0
    fj, ft = NONLINS[nonlin]
    fns = {"K1": (pc.conv3x3_tile_sparse, tsc.conv3x3_tile_sparse),
           "K4": (pc.conv3x3_tile_sparse_2d, tsc.conv3x3_tile_sparse_2d)}
    ref, ours = _both(*fns[kernel], x, w, b, mask, pad_mode, pad_mode,
                      fj, ft)
    assert ours.dtype == np.float32 and ours.shape == (2, 20, 72, 5)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_plain_epilogues_are_the_pallas_ones():
    """The port's epilogue functions compute what pallas_conv's do."""
    v = np.linspace(-6, 6, 101).astype(np.float32)
    for name, (fj, ft) in NONLINS.items():
        if fj is not None:
            np.testing.assert_allclose(ft(torch.from_numpy(v)).numpy(),
                                       np.asarray(fj(jnp.asarray(v))),
                                       atol=1e-7, err_msg=name)


def test_cpu_path_counts_no_launch_and_returns_f32():
    x, w, b = _data(h=8, w=16, cin=4, cout=3, n=1)
    mask = np.ones((1, 8, 16, 1), np.float32)
    tsc.reset_launches()
    out = tsc.conv3x3_tile_sparse_2d(
        torch.from_numpy(x).double(), torch.from_numpy(w),
        torch.from_numpy(b), torch.from_numpy(mask))
    assert out.dtype == torch.float32
    assert tsc.launches == {"conv3x3_tile_sparse": 0,
                            "conv3x3_tile_sparse_2d": 0}


def test_other_devices_raise():
    x = torch.zeros(1, 8, 16, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tsc.conv3x3_tile_sparse(x, torch.zeros(3, 3, 4, 2),
                                torch.zeros(2), torch.zeros(1, 8, 16, 1))


# --- the kernel's arithmetic: 3xTF32 --------------------------------------

def _tf32(a):
    """float32 -> TF32 (10 mantissa bits), rounding to nearest with ties
    away from zero, as cvt.rna.tf32.f32 does."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_trunc(a):
    """float32 -> TF32 by dropping the low 13 bits, as the tensor cores
    read a float32 register given as a TF32 operand."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _im2col(x):
    """(H, W, Cin) zero-padded -> (H * W, 9 * Cin) in HWIO's tap order."""
    h, w, _ = x.shape
    xp = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    return np.concatenate([xp[ky:ky + h, kx:kx + w].reshape(h * w, -1)
                           for ky in range(3) for kx in range(3)], 1)


@pytest.mark.parametrize("cin,cout", [(256, 128), (128, 3), (128, 64),
                                      (64, 3), (64, 32), (96, 32), (32, 3)])
def test_3xtf32_emulation_meets_the_contract(cin, cout):
    """The kernel splits each operand v into hi = tf32(v) (rounded) and
    lo = v - hi, which the tensor cores read truncated to TF32, and sums
    lo*hi + hi*lo + hi*hi in float32 (products of TF32 values are exact
    in float32). At the decoder convs' (Cin, Cout) that stays within the
    1e-4 contract of a float64 conv; one TF32 product (hi*hi) does not."""
    rng = np.random.RandomState(cin + cout)
    x = rng.randn(8, 16, cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
    a, b = _im2col(x), w.reshape(9 * cin, cout)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
    three = (a_lo @ b_hi).astype(np.float32) + (a_hi @ b_lo) + (a_hi @ b_hi)
    assert three.dtype == np.float32
    assert np.abs(three - exact).max() <= 1e-4
    assert np.abs((a_hi @ b_hi) - exact).max() > 1e-4


def test_tf32_rounding_keeps_10_mantissa_bits():
    """The rounding the kernel writes as two integer operations."""
    v = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                  1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11), 3.0e-3],
                 np.float32)
    t = _tf32(v)
    np.testing.assert_array_equal(
        t[:5], np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10)], np.float32))
    assert np.all(t.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert abs(t[5] - v[5]) <= 2.0 ** -11 * v[5]
    assert _tf32_trunc(np.float32(1.0 + 2.0 ** -11)) == 1.0


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K4"])
@pytest.mark.parametrize("shape", [(2, 24, 80, 128, 64), (2, 20, 72, 6, 5),
                                   (1, 12, 40, 256, 3)])
def test_kernel_matches_plain_on_card(cuda_device, kernel, shape):
    n, h, wd, cin, cout = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(n, h, wd, cin, generator=g).to(cuda_device)
    w = (torch.randn(3, 3, cin, cout, generator=g) * 0.1).to(cuda_device)
    b = torch.randn(cout, generator=g).to(cuda_device)
    m = (torch.rand(n, h, wd, 1, generator=g) > 0.9).float().to(cuda_device)
    fn = {"K1": tsc.conv3x3_tile_sparse,
          "K4": tsc.conv3x3_tile_sparse_2d}[kernel]
    key = fn.__name__
    before = tsc.launches[key]
    for pad_mode in ("reflect", "zero", "replicate"):
        for _, nl in NONLINS.values():
            out = fn(x, w, b, m, pad_mode, nl)
            ref = tsc.conv3x3_masked_plain(x, w, b, m, pad_mode, nl)
            torch.cuda.synchronize()
            assert float((out - ref).abs().max()) <= 1e-4
    assert tsc.launches[key] == before + 15


@pytest.mark.cuda
def test_kernel_rejects_bf16_on_card(cuda_device):
    x = torch.zeros(1, 8, 16, 4, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        tsc.conv3x3_tile_sparse(
            x, torch.zeros(3, 3, 4, 2, device=cuda_device),
            torch.zeros(2, device=cuda_device),
            torch.zeros(1, 8, 16, 1, device=cuda_device))


def _card_case(case, dev):
    """(x, w, b, mask, tolerance) of an edge case, from a seeded CPU
    generator."""
    shapes = {"ragged": (2, 13, 70, 16, 40), "large_x": (2, 20, 72, 24, 16),
              "cin33_cout17": (2, 20, 72, 33, 17),
              "cin12_cout6": (2, 9, 130, 12, 6),
              "all_zero": (2, 16, 128, 32, 32),
              "all_one": (2, 16, 128, 32, 32),
              "corner_pixel": (2, 24, 200, 64, 32)}
    n, h, wd, cin, cout = shapes[case]
    g = torch.Generator().manual_seed(len(case) * 7 + h)
    x = torch.randn(n, h, wd, cin, generator=g)
    w = torch.randn(3, 3, cin, cout, generator=g) * (2.0 / (9 * cin)) ** 0.5
    if case == "large_x":
        # |x| up to 1e2 with outputs of order 1: the split must keep the
        # low bits of large operands
        x = (torch.rand(n, h, wd, cin, generator=g) * 2 - 1) * 100.0
        w = w * 0.01
    b = torch.randn(cout, generator=g) * 0.1
    m = (torch.rand(n, h, wd, 1, generator=g) > 0.8).float()
    if case == "all_zero":
        m = torch.zeros(n, h, wd, 1)
    elif case == "all_one":
        m = torch.ones(n, h, wd, 1)
    elif case == "corner_pixel":
        # one active pixel per image, at the last row and column of a
        # granule: the whole granule is computed, the rest skipped
        m = torch.zeros(n, h, wd, 1)
        m[0, 7, 63] = 1.0
        m[1, 23, 199] = 1.0
    return [t.to(dev) for t in (x, w, b, m)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K4"])
@pytest.mark.parametrize("case", ["ragged", "large_x", "cin33_cout17",
                                  "cin12_cout6", "all_zero", "all_one",
                                  "corner_pixel"])
def test_kernel_edge_cases_on_card(cuda_device, kernel, case):
    """Ragged H (not a multiple of 8) and W (not of 64), a Cout that is
    not a multiple of the 32-channel block, |x| up to 1e2, Cin not a
    multiple of the 8-channel staging chunk (and not of 4: the 4-byte
    staging path), all-zero / all-one masks and single-pixel granules,
    every pad mode; within 1e-4 of the plain version."""
    x, w, b, m = _card_case(case, cuda_device)
    fn = {"K1": tsc.conv3x3_tile_sparse,
          "K4": tsc.conv3x3_tile_sparse_2d}[kernel]
    for pad_mode in ("reflect", "zero", "replicate"):
        out = fn(x, w, b, m, pad_mode, tsc.elu)
        ref = tsc.conv3x3_masked_plain(x, w, b, m, pad_mode, tsc.elu)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == torch.float32
        assert float((out - ref).abs().max()) <= 1e-4, pad_mode
    if case == "all_zero":
        assert not out.any()
    if case == "corner_pixel":
        assert int((out != 0).any(-1).sum()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_kernel_is_not_plain_tf32_on_card(cuda_device, kernel):
    """At 256 -> 128 channels the kernel agrees with float64 far better
    than one TF32 product could (~1e-3, see the emulation test)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 16, 64, 256, generator=g)
    w = torch.randn(3, 3, 256, 128, generator=g) * 0.05
    b, m = torch.zeros(128), torch.ones(1, 16, 64, 1)
    exact = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    fn = {"K1": tsc.conv3x3_tile_sparse,
          "K4": tsc.conv3x3_tile_sparse_2d}[kernel]
    out = fn(*(t.to(cuda_device) for t in (x, w, b, m)), "zero")
    assert float((out.cpu().double() - exact).abs().max()) <= 5e-5
