"""Port parity, ops layer: every op of wavelet_monodepth_tpu_torch's
ops/image.py, convops.py, wavelets.py, sparse.py and geometry.py against
its JAX counterpart on the same numpy inputs (CPU).

Tolerances: 1e-5 absolute for float ops (different conv/reduction
orders on the two CPU backends); exact for masks, op counts and pure
data movement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wavelet_monodepth_tpu.ops import convops as jconv
from wavelet_monodepth_tpu.ops import geometry as jgeo
from wavelet_monodepth_tpu.ops import image as jimg
from wavelet_monodepth_tpu.ops import sparse as jsp
from wavelet_monodepth_tpu.ops import wavelets as jwav
from wavelet_monodepth_tpu_torch.ops import convops as tconv
from wavelet_monodepth_tpu_torch.ops import geometry as tgeo
from wavelet_monodepth_tpu_torch.ops import image as timg
from wavelet_monodepth_tpu_torch.ops import sparse as tsp
from wavelet_monodepth_tpu_torch.ops import wavelets as twav

torch.set_num_threads(1)
ATOL = 1e-5


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _mask(shape, p, seed):
    return (np.random.RandomState(seed).rand(*shape) < p).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _oihw(w_hwio):
    return _t(np.transpose(w_hwio, (3, 2, 0, 1)))


@pytest.mark.parametrize("mode", ["reflect", "zero", "replicate"])
@pytest.mark.parametrize("pad", [1, 2])
def test_pad2d(mode, pad):
    x = _rand((2, 5, 7, 3))
    np.testing.assert_array_equal(
        _np(timg.pad2d(_t(x), pad, mode)),
        _np(jimg.pad2d(jnp.asarray(x), pad, mode)))


def test_upsample_nearest2x():
    x = _rand((2, 3, 5, 4))
    np.testing.assert_array_equal(_np(timg.upsample_nearest2x(_t(x))),
                                  _np(jimg.upsample_nearest2x(jnp.asarray(x))))


@pytest.mark.parametrize("k", [3, 5])
def test_max_pool_same_and_dilate(k):
    m = _mask((2, 9, 11, 1), 0.1, seed=k)
    np.testing.assert_array_equal(_np(timg.max_pool_same(_t(m), k)),
                                  _np(jimg.max_pool_same(jnp.asarray(m), k)))
    np.testing.assert_array_equal(_np(timg.dilate_mask(_t(m), k)),
                                  _np(jimg.dilate_mask(jnp.asarray(m), k)))
    # -inf padding: an all-zero mask stays zero at the borders
    z = np.zeros((1, 6, 6, 1), np.float32)
    assert not _np(timg.dilate_mask(_t(z), k)).any()


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(20, 30), (37, 61)])
def test_resize_bilinear_upsampling(align_corners, size):
    x = _rand((2, 8, 12, 3), seed=1)
    np.testing.assert_allclose(
        _np(timg.resize_bilinear(_t(x), *size, align_corners=align_corners)),
        _np(jimg.resize_bilinear(jnp.asarray(x), *size,
                                 align_corners=align_corners)), atol=ATOL)


@pytest.mark.parametrize("stride,padding", [(1, "VALID"), (1, "SAME"),
                                            (2, "VALID")])
def test_conv2d(stride, padding):
    x, w, b = _rand((2, 9, 10, 4)), _rand((3, 3, 4, 5), 1, 0.3), _rand((5,), 2)
    np.testing.assert_allclose(
        _np(tconv.conv2d(_t(x), _oihw(w), _t(b), stride, padding)),
        _np(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         stride, padding)), atol=ATOL)


@pytest.mark.parametrize("pad_mode", ["reflect", "zero", "replicate"])
def test_conv3x3_and_conv1x1(pad_mode):
    x = _rand((2, 8, 11, 6))
    w3, b3 = _rand((3, 3, 6, 4), 1, 0.3), _rand((4,), 2)
    w1, b1 = _rand((1, 1, 6, 7), 3, 0.3), _rand((7,), 4)
    np.testing.assert_allclose(
        _np(tconv.conv3x3(_t(x), _oihw(w3), _t(b3), pad_mode)),
        _np(jconv.conv3x3(jnp.asarray(x), jnp.asarray(w3), jnp.asarray(b3),
                          pad_mode)), atol=ATOL)
    np.testing.assert_allclose(
        _np(tconv.conv1x1(_t(x), _oihw(w1), _t(b1))),
        _np(jconv.conv1x1(jnp.asarray(x), jnp.asarray(w1),
                          jnp.asarray(b1))), atol=ATOL)


def test_haar_idwt_and_stacked():
    bands = [_rand((2, 4, 6, 3), s) for s in range(4)]
    ours = twav.haar_idwt(*map(_t, bands))
    np.testing.assert_array_equal(
        _np(ours), _np(jwav.haar_idwt(*map(jnp.asarray, bands))))
    yh = np.stack(bands[1:], axis=-1)
    np.testing.assert_array_equal(
        _np(twav.haar_idwt_stacked(_t(bands[0]), _t(yh))), _np(ours))


def test_haar_dwt_roundtrip_and_parity():
    x = _rand((2, 8, 12, 2), 5)
    ours = twav.haar_dwt(_t(x))
    for a, b in zip(ours, jwav.haar_dwt(jnp.asarray(x))):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_allclose(_np(twav.haar_idwt(*ours)), x, atol=ATOL)


@pytest.mark.parametrize("shape,J", [((1, 16, 24, 1), 3),
                                     ((2, 12, 20, 2), 3)])
def test_haar_dwt_J(shape, J):
    """(12, 20) reaches odd intermediate sizes: edge padding must agree."""
    x = _rand(shape, 6)
    yl_t, highs_t = twav.haar_dwt_J(_t(x), J)
    yl_j, highs_j = jwav.haar_dwt_J(jnp.asarray(x), J)
    np.testing.assert_array_equal(_np(yl_t), _np(yl_j))
    for lt, lj in zip(highs_t, highs_j):
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("ratio", [0.05, 0.2, -1.0])
def test_wavelet_threshold_mask(ratio):
    """Masks agree exactly away from the threshold; a flip is allowed only
    where |yh| lies within 1e-5 of it (float rounding of the per-image
    threshold). Both sides compute the same f32 ops, so none is seen."""
    yl, yh = _rand((3, 4, 6, 1), 7), _rand((3, 8, 12, 3), 8, 0.3)
    ours = _np(tsp.wavelet_threshold_mask(_t(yl), _t(yh), ratio))
    ref = _np(jsp.wavelet_threshold_mask(jnp.asarray(yl), jnp.asarray(yh),
                                         ratio))
    thresh = (yl.max(axis=(1, 2, 3)) - yl.min(axis=(1, 2, 3))) * ratio
    margin = np.abs(np.abs(yh).max(-1, keepdims=True)
                    - thresh[:, None, None, None])
    assert ours.shape == ref.shape == (3, 8, 12, 1)
    assert np.all((ours == ref) | (margin < 1e-5))


def test_stage_masks():
    m = _mask((2, 6, 8, 1), 0.08, 9)
    ours = tsp.stage_masks(_t(m))
    ref = jsp.stage_masks(jnp.asarray(m))
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(_np(ours[k]), _np(ref[k]), err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pad_mode", ["reflect", "zero"])
def test_masked_conv3x3(masked, pad_mode):
    x = _rand((2, 8, 10, 5))
    w, b = _rand((3, 3, 5, 4), 1, 0.3), _rand((4,), 2)
    mi = _mask((2, 8, 10, 1), 0.5, 3) if masked else None
    mo = _mask((2, 8, 10, 1), 0.5, 4) if masked else None
    opt = (lambda a, f: None if a is None else f(a))
    ours = tsp.masked_conv3x3(_t(x), _oihw(w), _t(b), opt(mi, _t),
                              opt(mo, _t), pad_mode, F.elu)
    ref = jsp.masked_conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             opt(mi, jnp.asarray), opt(mo, jnp.asarray),
                             pad_mode, jax.nn.elu)
    np.testing.assert_allclose(_np(ours), _np(ref), atol=ATOL)


def test_masked_waveconv_and_upsample_concat():
    x = _rand((2, 8, 10, 6))
    w1, b1 = _rand((1, 1, 6, 6), 1, 0.3), _rand((6,), 2)
    w3, b3 = _rand((3, 3, 6, 3), 3, 0.3), _rand((3,), 4)
    mi, mo = _mask((2, 8, 10, 1), 0.5, 5), _mask((2, 8, 10, 1), 0.3, 6)
    ours = tsp.masked_waveconv(_t(x), _oihw(w1), _t(b1), _oihw(w3), _t(b3),
                               _t(mi), _t(mo))
    ref = jsp.masked_waveconv(*map(jnp.asarray, (x, w1, b1, w3, b3, mi, mo)))
    np.testing.assert_allclose(_np(ours), _np(ref), atol=ATOL)

    lo, skip = _rand((2, 4, 5, 3), 7), _rand((2, 8, 10, 2), 8)
    np.testing.assert_array_equal(
        _np(tsp.masked_upsample_concat(_t(lo), _t(skip), _t(mo))),
        _np(jsp.masked_upsample_concat(jnp.asarray(lo), jnp.asarray(skip),
                                       jnp.asarray(mo))))


@pytest.mark.parametrize("per_image", [False, True])
def test_compute_density_and_mask_count(per_image):
    outs = {("wavelet_mask", i): _mask((3, 4 * 2 ** i, 6 * 2 ** i, 1),
                                       0.1 + 0.2 * i, 10 + i)
            for i in range(3)}
    ours = tsp.compute_density({k: _t(v) for k, v in outs.items()},
                               per_image=per_image)
    ref = jsp.compute_density({k: jnp.asarray(v) for k, v in outs.items()},
                              per_image=per_image)
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-6)
    m = outs[("wavelet_mask", 2)]
    np.testing.assert_array_equal(_np(tsp.mask_count(_t(m))),
                                  _np(jsp.mask_count(jnp.asarray(m))))
    with pytest.raises(ValueError):
        tsp.compute_density({})


def test_op_counters_equal_exactly():
    m = _mask((3, 12, 20, 1), 0.3, 11)
    n = tsp.mask_count(_t(m))
    nj = jsp.mask_count(jnp.asarray(m))
    pairs = [
        (tsp.ops_mask2idxmap(_t(m)), jsp.ops_mask2idxmap(jnp.asarray(m))),
        (tsp.ops_threshold(_t(m)), jsp.ops_threshold(jnp.asarray(m))),
        (tsp.ops_dilation(_t(m)), jsp.ops_dilation(jnp.asarray(m))),
        (tsp.ops_sparse_conv3x3(n, 96, 32), jsp.ops_sparse_conv3x3(nj, 96, 32)),
        (tsp.ops_sparse_conv1x1(n, 64, 64), jsp.ops_sparse_conv1x1(nj, 64, 64)),
        (tsp.ops_dense_conv3x3((3, 24, 80, 256), 128),
         jsp.ops_dense_conv3x3((3, 24, 80, 256), 128)),
        (tsp.ops_dense_conv3x3_nyu((3, 24, 80, 256), 128),
         jsp.ops_dense_conv3x3_nyu((3, 24, 80, 256), 128)),
        (tsp.ops_dense_conv1x1((3, 24, 80, 256), 256, 64),
         jsp.ops_dense_conv1x1((3, 24, 80, 256), 256, 64)),
        (tsp.ops_idwt((3, 48, 160, 1)), jsp.ops_idwt((3, 48, 160, 1))),
    ]
    for i, (a, b) in enumerate(pairs):
        assert a.dtype == torch.float32, i
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=str(i))


def test_disp_to_depth():
    d = np.random.RandomState(12).rand(2, 6, 8, 1).astype(np.float32)
    for a, b in zip(tgeo.disp_to_depth(_t(d), 0.1, 100),
                    jgeo.disp_to_depth(jnp.asarray(d), 0.1, 100)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)
