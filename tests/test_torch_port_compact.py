"""Port parity, the tile-compact engine: wavelet_monodepth_tpu_torch's
ops/blockio.py (K5 band_gather, K6 block_scatter, wtile_stack) and
ops/compact.py against the JAX package's, with the Pallas kernels in
interpret mode as tests/test_compact.py runs them.

Tolerances: wtile_stack, the gathers and the scatters are copies, so
they are compared bitwise; compact_wave_stage within 1e-5 over the whole
tensors, the image-border ring included (XLA-CPU and ATen sum the convs
in different orders); overflow counts exactly. In bfloat16 (the dtype of
the bf16 compact backend) the copies are again bitwise, and the stage
is held to BF16_RTOL of each output's largest value. The scatter
kernel's address arithmetic is emulated in numpy and held bitwise
against JAX's scatter on the CPU. The CUDA kernels are checked against
the plain versions, in float32 and bfloat16, by the `cuda`-marked tests
at the end (and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavelet_monodepth_tpu.ops import blockio as jbio
from wavelet_monodepth_tpu.ops import compact as jcp
from wavelet_monodepth_tpu_torch.ops import blockio as bio
from wavelet_monodepth_tpu_torch.ops import compact as cp

torch.set_num_threads(1)
ATOL = 1e-5
BF16_RTOL = 0.03
N, HL, WL, CX, CS, CD = 2, 16, 40, 64, 64, 32


def _params(rng, cx, cs, cd):
    shapes = [(3, 3, cx, cd), (cd,), (3, 3, cd + cs, cd), (cd,),
              (1, 1, cd, cd), (cd,), (3, 3, cd, 3), (3,),
              (1, 1, cd, cd), (cd,), (3, 3, cd, 3), (3,)]
    scale = [0.05, 0.1, 0.05, 0.1] + [0.1] * 8
    return [(rng.randn(*s) * a).astype(np.float32)
            for s, a in zip(shapes, scale)]


@pytest.fixture(scope="module")
def stage_case():
    """tests/test_compact.py's stage shapes (n=2, 16x40 low res, Cx=Cs=64,
    Cd=32), inputs from a numpy seed; an edge-like mask (15% dense) and an
    all-ones one (every tile scores the same: the top-K order is ties
    only)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(N, HL, WL, CX) * 0.5).astype(np.float32)
    skip = (rng.randn(N, 2 * HL, 2 * WL, CS) * 0.5).astype(np.float32)
    mask = (rng.rand(N, HL, WL, 1) > 0.85).astype(np.float32)
    ones = np.ones_like(mask)
    return x, skip, {"edges": mask, "ones": ones}, _params(rng, CX, CS, CD)


def _stage(module, arrays, to, i_scale=1, **kw):
    x, skip, mask, prm = arrays
    return module.compact_wave_stage(to(x), to(skip), to(mask),
                                     *[to(p) for p in prm],
                                     i_scale=i_scale, **kw)


@pytest.mark.parametrize("halo,th,tw,pad_mode,c", [
    (2, 4, 16, "reflect", 5), (1, 8, 32, "zero", 1),
    (0, 8, 16, "reflect", 3), (1, 4, 17, "replicate", 1)])
def test_wtile_stack_and_block_io_bitwise(halo, th, tw, pad_mode, c):
    """wtile_stack, band_gather (window th..2*th rows, idx at every tile
    including the last row block) and block_scatter equal JAX's exactly,
    at aligned and unaligned (C=1, odd width) row widths."""
    rng = np.random.RandomState(th + tw + c)
    n, h, w = 2, 13, 37
    x = rng.randn(n, h, w, c).astype(np.float32)
    ours = bio.wtile_stack(torch.from_numpy(x), th, tw, halo, pad_mode)
    ref = np.asarray(jbio.wtile_stack(jnp.asarray(x), th, tw, halo,
                                      pad_mode))
    np.testing.assert_array_equal(ours.numpy(), ref)

    nh, nw = -(-h // th), -(-w // tw)
    tiles = np.stack(np.meshgrid(np.arange(n), np.arange(nh), np.arange(nw),
                                 indexing="ij"), -1).reshape(-1, 3)
    idx = tiles[rng.permutation(len(tiles))].astype(np.int32)
    for window_h in sorted({th, th + 2 * halo, 2 * th}):
        g = bio.band_gather(ours, torch.from_numpy(idx), th, window_h)
        gj = jbio.band_gather(jnp.asarray(ref), jnp.asarray(idx), th,
                              window_h, interpret=True)
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))

    vals = rng.randn(len(idx) - 3, th, tw, c).astype(np.float32)
    sub = idx[3:]
    s = bio.block_scatter(torch.from_numpy(vals), torch.from_numpy(sub), n,
                          nh, nw)
    sj = jbio.block_scatter(jnp.asarray(vals), jnp.asarray(sub), n, nh, nw,
                            interpret=True)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_block_scatter_rejects_duplicate_or_outside_idx():
    vals = torch.zeros(2, 4, 8, 3)
    for bad in ([[0, 1, 1], [0, 1, 1]], [[0, 0, 0], [0, 2, 0]],
                [[0, 0, 0], [-1, 0, 0]]):
        with pytest.raises(ValueError, match="distinct"):
            bio.block_scatter(vals, torch.tensor(bad, dtype=torch.int32),
                              1, 2, 2)
    with pytest.raises(ValueError, match="2\\*th"):
        bio.band_gather(torch.zeros(1, 1, 3, 4, 8, 1),
                        torch.zeros(1, 3, dtype=torch.int32), 4, 9)


@pytest.mark.parametrize("io", ["pallas", "xla"])
@pytest.mark.parametrize("th,tw", [(8, 16), (8, 32)])
def test_compact_stage_matches_jax(stage_case, io, th, tw):
    x, skip, masks, prm = stage_case
    arrays = (x, skip, masks["edges"], prm)
    yh, x1 = _stage(cp, arrays, torch.from_numpy, th=th, tw=tw,
                    cap_ratio=1.0, io=io)
    yh_j, x1_j = _stage(jcp, arrays, jnp.asarray, th=th, tw=tw,
                        cap_ratio=1.0, io=io)
    assert yh.shape == (N, 2 * HL, 2 * WL, 3) and x1.shape[-1] == CD
    np.testing.assert_allclose(yh.numpy(), np.asarray(yh_j), atol=ATOL)
    np.testing.assert_allclose(x1.numpy(), np.asarray(x1_j), atol=ATOL)


@pytest.mark.parametrize("mask", ["edges", "ones"])
def test_compact_stage_starved_capacity_matches_jax(stage_case, mask):
    """Past capacity the dropped tiles are JAX's: with every tile scoring
    the same, only the tie order picks the K survivors."""
    x, skip, masks, prm = stage_case
    arrays = (x, skip, masks[mask], prm)
    kw = {"th": 8, "tw": 16, "cap_ratio": 0.3}
    over = cp.stage_capacity_overflow(torch.from_numpy(masks[mask]), 8, 16,
                                      0.3)
    over_j = jcp.stage_capacity_overflow(jnp.asarray(masks[mask]), 8, 16,
                                         0.3)
    assert int(over) == int(over_j) > 0
    for io in ("pallas", "xla"):
        yh, x1 = _stage(cp, arrays, torch.from_numpy, io=io, **kw)
        yh_j, x1_j = _stage(jcp, arrays, jnp.asarray, io="pallas", **kw)
        np.testing.assert_allclose(yh.numpy(), np.asarray(yh_j), atol=ATOL)
        np.testing.assert_allclose(x1.numpy(), np.asarray(x1_j), atol=ATOL)


def test_stage_primitives_match_jax():
    rng = np.random.RandomState(1)
    m = (rng.rand(2, 16, 36, 1) > 0.8).astype(np.float32)
    mt, mj = torch.from_numpy(m), jnp.asarray(m)
    for th, tw in ((8, 8), (8, 16), (4, 32)):
        np.testing.assert_array_equal(cp.tile_scores(mt, th, tw).numpy(),
                                      np.asarray(jcp.tile_scores(mj, th, tw)))
        for k in (0, 3, 9, 100):
            assert (int(cp.stage_overflow(mt, th, tw, k))
                    == int(jcp.stage_overflow(mj, th, tw, k)))
        for cap in (0.05, 0.5, 1.0):
            assert (int(cp.stage_capacity_overflow(mt, th, tw, cap))
                    == int(jcp.stage_capacity_overflow(mj, th, tw, cap)))
    for hh, wh in ((8, 12), (24, 80), (32, 40), (96, 320)):
        assert cp.default_tile_shape(hh, wh) == jcp.default_tile_shape(hh, wh)
    x = rng.randn(2, 20, 24, 3).astype(np.float32)
    tiles = cp._pretile(torch.from_numpy(x), 8, 8, 3, 3, 2)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(jcp._pretile(jnp.asarray(x), 8, 8, 3, 3,
                                               2)))
    idx = rng.permutation(18)[:11]
    out = cp._scatter(tiles[:11, 2:-2, 2:-2], torch.from_numpy(idx), 2, 3, 3,
                      8, 8, 20, 24)
    ref = jcp._scatter(jnp.asarray(tiles.numpy()[:11, 2:-2, 2:-2]),
                       jnp.asarray(idx), 2, 3, 3, 8, 8, 20, 24)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("halo,th,tw,c", [(2, 4, 16, 5), (1, 8, 17, 1),
                                           (2, 8, 9, 1)])
def test_block_io_bf16_bitwise_matches_jax(halo, th, tw, c):
    """In bfloat16 (the dtype of JAX's bf16 compact backend), wtile_stack
    and the plain K5/K6 equal JAX's kernels in interpret mode bitwise,
    C=1 rows of odd widths included."""
    rng = np.random.RandomState(th + tw + c + 1)
    n, h, w = 2, 13, 37
    x = rng.randn(n, h, w, c).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)

    def same(t, j):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        # bf16 -> f32 is exact and one-to-one
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))

    stack = bio.wtile_stack(xt, th, tw, halo)
    stack_j = jbio.wtile_stack(xj, th, tw, halo)
    same(stack, stack_j)
    nh, nw = -(-h // th), -(-w // tw)
    tiles = np.stack(np.meshgrid(np.arange(n), np.arange(nh), np.arange(nw),
                                 indexing="ij"), -1).reshape(-1, 3)
    idx = tiles[rng.permutation(len(tiles))].astype(np.int32)
    for window_h in sorted({th, th + 2 * halo, 2 * th}):
        same(bio.band_gather(stack, torch.from_numpy(idx), th, window_h),
             jbio.band_gather(stack_j, jnp.asarray(idx), th, window_h,
                              interpret=True))
    vals = rng.randn(len(idx) - 2, th, tw, c).astype(np.float32)
    same(bio.block_scatter(torch.from_numpy(vals).to(torch.bfloat16),
                           torch.from_numpy(idx[2:]), n, nh, nw),
         jbio.block_scatter(jnp.asarray(vals, jnp.bfloat16),
                            jnp.asarray(idx[2:]), n, nh, nw,
                            interpret=True))


@pytest.mark.parametrize("io", ["pallas", "xla"])
def test_compact_stage_bf16_matches_jax(stage_case, io):
    """The stage in bfloat16 (inputs and weights) against JAX's bf16
    stage: outputs stay bfloat16, and agree within BF16_RTOL of each
    tensor's largest value (both round each conv's float32 sums to
    bfloat16, from sums taken in different orders; measured: 1.6% for
    yh, 8 bf16 ulps at 0.48, and 0.5% for x1, one ulp at 3.2)."""
    x, skip, masks, prm = stage_case
    arrays = (x, skip, masks["edges"], prm)
    yh, x1 = _stage(cp, arrays,
                    lambda a: torch.from_numpy(a).to(torch.bfloat16),
                    th=8, tw=16, cap_ratio=1.0, io=io)
    yh_j, x1_j = _stage(jcp, arrays, lambda a: jnp.asarray(a, jnp.bfloat16),
                        th=8, tw=16, cap_ratio=1.0, io=io)
    assert yh.dtype == x1.dtype == torch.bfloat16
    assert yh_j.dtype == x1_j.dtype == jnp.bfloat16
    for ours, ref in ((yh, yh_j), (x1, x1_j)):
        err = np.abs(ours.float().numpy() - np.asarray(ref, np.float32))
        peak = np.abs(np.asarray(ref, np.float32)).max()
        assert err.max() <= BF16_RTOL * peak, (err.max(), peak)


# --- the scatter kernel's row walk, emulated ----------------------------------

# (n, nh, nw, th, tw, C, which idx rows): the six block_scatter calls of a
# B=16 640x192 compact forward at compact_cap 0.5 (yh and x1 per scale),
# then the edge cases: no row, every tile, one tile, only the last row
# and column blocks, and runs of tw*C elements that are no multiple of
# 16 bytes (the kernel's element path)
SCATTER_CASES = {
    "scale3_yh": (16, 3, 3, 8, 32, 3, "half"),
    "scale3_x1": (16, 3, 3, 8, 32, 128, "half"),
    "scale2_yh": (16, 6, 5, 8, 32, 3, "half"),
    "scale2_x1": (16, 6, 5, 8, 32, 64, "half"),
    "scale1_yh": (16, 12, 10, 8, 32, 3, "half"),
    "scale1_x1": (16, 12, 10, 8, 32, 32, "half"),
    "no_row": (2, 3, 4, 8, 32, 3, "none"),
    "every_tile": (2, 3, 4, 8, 32, 16, "all"),
    "one_tile": (2, 3, 4, 8, 32, 3, "one"),
    "last_row_and_column": (2, 3, 5, 8, 16, 8, "edge"),
    "c1_tw17": (2, 3, 5, 8, 17, 1, "half"),
    "c3_tw7": (2, 3, 5, 8, 7, 3, "half"),
}


def _scatter_case(name):
    """(vals float32 (K, th, tw, C), idx int32 (K, 3), n, nh, nw) from a
    numpy seed; idx rows distinct, in a random order."""
    n, nh, nw, th, tw, c, rows = SCATTER_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    tiles = np.stack(np.meshgrid(np.arange(n), np.arange(nh), np.arange(nw),
                                 indexing="ij"), -1).reshape(-1, 3)
    order = rng.permutation(len(tiles))
    pick = {"half": order[:len(order) // 2], "all": order,
            "none": order[:0], "one": order[:1],
            "edge": [i for i in order
                     if tiles[i, 1] == nh - 1 or tiles[i, 2] == nw - 1]}
    idx = tiles[pick[rows]].reshape(-1, 3).astype(np.int32)
    vals = rng.randn(len(idx), th, tw, c).astype(np.float32)
    return vals, idx, n, nh, nw


def _bits(t: torch.Tensor) -> np.ndarray:
    """A float32 or bfloat16 tensor's bits as unsigned integers."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _fast_div(d: int):
    """csrc/blockio.cu's fast_div: (magic, shift) with n // d ==
    (umulhi(n, magic) + n) >> shift for 0 <= n < 2**31."""
    s = 0
    while (1 << s) < d:
        s += 1
    return np.uint64(((1 << 32) * ((1 << s) - d)) // d + 1), np.uint64(s)


def _divide(n: np.ndarray, d: int) -> np.ndarray:
    m, s = _fast_div(d)
    return (((n * m) >> np.uint64(32)) + n) >> s


def emulate_scatter_kernel(vals: np.ndarray, idx: np.ndarray, n: int,
                           nh: int, nw: int, unit: int):
    """block_scatter_kernel of csrc/blockio.cu in numpy, on the raw bytes
    of vals (K, th, tw, C) in `unit`-byte units (16: the vector path; the
    element size: the element path): the inverse table that its atomicMax
    loop leaves in shared memory, the faults it counts, then the walk over
    the canvas's flat units, each unit's slice, canvas row and tile row
    found by the kernel's multiply-and-shift divisions. Returns (canvas
    bytes as vals' dtype (N, nh*th, nw*tw, C), faults)."""
    k, th, tw, c = vals.shape
    run = tw * c * vals.dtype.itemsize
    assert run % unit == 0
    length = run // unit
    units = np.ascontiguousarray(vals).view(np.uint8).reshape(-1, unit)
    inv = np.full(n * nh * nw, -1, np.int64)
    faults = 0
    for row, (b, ty, tx) in enumerate(idx.tolist()):
        if not (0 <= b < n and 0 <= ty < nh and 0 <= tx < nw):
            faults += 1
            continue
        tile = (b * nh + ty) * nw + tx
        faults += int(inv[tile] >= 0)
        inv[tile] = max(inv[tile], row)
    total = n * nh * th * nw * length
    out = np.zeros((total, unit), np.uint8)
    step = 1 << 20
    for start in range(0, total, step):
        g = np.arange(start, min(total, start + step), dtype=np.uint64)
        s = _divide(g, length)              # slice (n, y, tx)
        q = _divide(s, nw)                  # canvas row (n, y)
        tx = s - q * np.uint64(nw)
        tr = _divide(q, th)                 # tile row n*nh + ty
        src_k = inv[(tr * np.uint64(nw) + tx).astype(np.int64)]
        r = (q - tr * np.uint64(th)).astype(np.int64)
        j = (g - s * np.uint64(length)).astype(np.int64)
        on = src_k >= 0
        out[start + np.flatnonzero(on)] = units[
            ((src_k * th + r) * length + j)[on]]
    return out.view(vals.dtype).reshape(n, nh * th, nw * tw, c), faults


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_kernel_row_walk_matches_jax(case, dtype):
    """The kernel's address arithmetic, emulated in numpy on both of its
    paths (16-byte units where a tile row's bytes allow them, elements
    always), equals JAX's block_scatter in interpret mode bitwise, at the
    serving path's six calls and the edge cases; no fault counted."""
    vals, idx, n, nh, nw = _scatter_case(case)
    t = torch.from_numpy(vals)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        raw = _bits(t)
        jvals = jnp.asarray(raw.view(jnp.bfloat16))
    else:
        raw = vals.view(np.uint32)
        jvals = jnp.asarray(vals)
    if len(idx):
        ref = np.asarray(jbio.block_scatter(jvals, jnp.asarray(idx), n, nh,
                                            nw, interpret=True))
        ref = ref.view(raw.dtype)
    else:   # interpret mode cannot trace zero grid steps: JAX's zeros operand
        th, tw, c = vals.shape[1:]
        ref = np.zeros((n, nh * th, nw * tw, c), raw.dtype)
    run = vals.shape[2] * vals.shape[3] * raw.itemsize
    paths = {raw.itemsize} | ({16} if run % 16 == 0 else set())
    assert (16 in paths) == (case not in ("c1_tw17", "c3_tw7"))
    for unit in sorted(paths):
        ours, faults = emulate_scatter_kernel(raw, idx, n, nh, nw, unit)
        assert faults == 0
        np.testing.assert_array_equal(ours, ref, err_msg=f"{unit}-byte "
                                      "units")


def test_cpu_path_counts_no_launch():
    bio.reset_launches()
    stack = bio.wtile_stack(torch.zeros(1, 8, 16, 2), 4, 8, 1)
    got = bio.band_gather(stack, torch.zeros(1, 3, dtype=torch.int32), 4, 6)
    bio.block_scatter(got[:, :4, :8], torch.zeros(1, 3, dtype=torch.int32),
                      1, 2, 2)
    assert bio.launches == {"band_gather": 0, "block_scatter": 0}


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,tw,halo", [(64, 16, 2), (1, 16, 1), (1, 17, 1),
                                       (3, 7, 0)])
def test_block_io_kernels_match_plain_on_card(cuda_device, c, tw, halo):
    """K5 and K6 equal their plain versions bitwise: 16-byte and scalar
    copies, every tile (the last row block included)."""
    g = torch.Generator().manual_seed(c + tw)
    n, h, w, th = 2, 20, 70, 8
    x = torch.randn(n, h, w, c, generator=g).to(cuda_device)
    stack = bio.wtile_stack(x, th, tw, halo)
    nh, nw = -(-h // th), -(-w // tw)
    idx = torch.stack(torch.meshgrid(torch.arange(n), torch.arange(nh),
                                     torch.arange(nw), indexing="ij"),
                      -1).reshape(-1, 3)
    idx = idx[torch.randperm(len(idx), generator=g)].to(torch.int32)
    idx = idx.to(cuda_device)
    before = dict(bio.launches)
    for window_h in (th, th + 2 * halo):
        out = bio.band_gather(stack, idx, th, window_h)
        assert torch.equal(out, bio.band_gather_plain(stack, idx, th,
                                                      window_h))
    vals = torch.randn(len(idx) - 1, th, tw, c, generator=g).to(cuda_device)
    out = bio.block_scatter(vals, idx[1:], n, nh, nw)
    assert torch.equal(out, bio.block_scatter_plain(vals, idx[1:], n, nh,
                                                    nw))
    torch.cuda.synchronize()
    assert bio.launches["band_gather"] == before["band_gather"] + 2
    assert bio.launches["block_scatter"] == before["block_scatter"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("c,tw,halo", [(64, 16, 2), (1, 16, 1), (1, 17, 1),
                                       (3, 7, 0), (1, 9, 2)])
def test_block_io_kernels_match_plain_in_bf16_on_card(cuda_device, c, tw,
                                                      halo):
    """The bfloat16 instances of K5 and K6 equal their plain versions
    bitwise, 16-byte and 2-byte copies (C=1 rows of odd widths), and
    count as bfloat16 launches; other dtypes raise."""
    g = torch.Generator().manual_seed(c + tw)
    n, h, w, th = 2, 21, 70, 8
    x = torch.randn(n, h, w, c, generator=g).to(cuda_device,
                                                torch.bfloat16)
    stack = bio.wtile_stack(x, th, tw, halo)
    nh, nw = -(-h // th), -(-w // tw)
    idx = torch.stack(torch.meshgrid(torch.arange(n), torch.arange(nh),
                                     torch.arange(nw), indexing="ij"),
                      -1).reshape(-1, 3)
    idx = idx[torch.randperm(len(idx), generator=g)].to(torch.int32)
    idx = idx.to(cuda_device)
    before = dict(bio.launches_bf16)
    for window_h in sorted({th, th + 2 * halo, 2 * th}):
        out = bio.band_gather(stack, idx, th, window_h)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, bio.band_gather_plain(stack, idx, th,
                                                      window_h))
    vals = torch.randn(len(idx) - 1, th, tw, c, generator=g).to(
        cuda_device, torch.bfloat16)
    out = bio.block_scatter(vals, idx[1:], n, nh, nw)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, bio.block_scatter_plain(vals, idx[1:], n, nh,
                                                    nw))
    torch.cuda.synchronize()
    assert bio.launches_bf16["band_gather"] == (
        before["band_gather"] + len({th, th + 2 * halo, 2 * th}))
    assert bio.launches_bf16["block_scatter"] == before["block_scatter"] + 1
    with pytest.raises(TypeError, match="bfloat16"):
        bio.band_gather(stack.half(), idx, th, th)


def _on_card(vals: np.ndarray, idx: np.ndarray, dtype, device):
    t = torch.from_numpy(vals).to(dtype)
    return t.to(device), torch.from_numpy(idx).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_block_scatter_kernel_bitwise_on_card(cuda_device, case, dtype):
    """K6 equals block_scatter_plain bit for bit at the serving path's six
    calls and the edge cases (no row, every tile, one tile, the last row
    and column blocks, 16-byte and element paths), launches once per
    call, with no row, and counts no fault."""
    vals, idx, n, nh, nw = _scatter_case(case)
    v, i = _on_card(vals, idx, dtype, cuda_device)
    faults = bio.scatter_faults(cuda_device)
    before = bio.launches["block_scatter"]
    out = bio.block_scatter(v, i, n, nh, nw)
    ref = bio.block_scatter_plain(v, i, n, nh, nw)
    assert out.dtype == dtype and out.shape == ref.shape
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert bio.launches["block_scatter"] == before + 1
    assert bio.scatter_faults(cuda_device) == faults


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", ["duplicate", "outside"])
def test_block_scatter_kernel_counts_faults_on_card(cuda_device, dtype,
                                                    fault):
    """A row naming a tile an earlier row named, or a row outside the
    block grid, adds one to scatter_faults and writes nothing outside its
    own tile: the canvas equals the plain scatter of the other rows (of a
    duplicated tile the kernel keeps the later row)."""
    vals, idx, n, nh, nw = _scatter_case("last_row_and_column")
    bad = idx.copy()
    if fault == "duplicate":
        bad[-1] = bad[0]
        keep = np.arange(1, len(idx))
    else:
        bad[2] = (n, 0, 0)
        keep = np.delete(np.arange(len(idx)), 2)
    v, i = _on_card(vals, bad, dtype, cuda_device)
    faults = bio.scatter_faults(cuda_device)
    out = bio.block_scatter(v, i, n, nh, nw)
    ref = bio.block_scatter_plain(v[keep], i[keep], n, nh, nw)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert bio.scatter_faults(cuda_device) == faults + 1
    with pytest.raises(ValueError, match="distinct"):
        bio.block_scatter(v.cpu(), i.cpu(), n, nh, nw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_scatter_kernel_writes_whole_canvas_on_card(cuda_device,
                                                          dtype):
    """The canvas comes from torch.empty: when the caching allocator hands
    back memory that held NaN, every element the kernel leaves is still
    written (zeros off the named tiles)."""
    vals, idx, n, nh, nw = _scatter_case("scale1_x1")
    v, i = _on_card(vals, idx, dtype, cuda_device)
    th, tw, c = vals.shape[1:]
    stale = torch.full((n, nh * th, nw * tw, c), float("nan"), dtype=dtype,
                       device=cuda_device)
    ptr = stale.data_ptr()
    del stale
    out = bio.block_scatter(v, i, n, nh, nw)
    assert out.data_ptr() == ptr, "the allocator did not reuse the block"
    assert not bool(torch.isnan(out).any())
    np.testing.assert_array_equal(
        _bits(out), _bits(bio.block_scatter_plain(v, i, n, nh, nw)))
