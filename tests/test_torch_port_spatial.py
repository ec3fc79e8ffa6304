"""Port parity, spatial (image-height) inference (`parallel/
spatial_hints.py` and the spatial functions of `parallel/mesh.py`):
eight gloo ranks on the CPU against the contracts of the JAX package's
tests/test_spatial.py, and the halo rule on one process.

One launch of tests/torch_spatial_worker.py (eight processes, one thread
each) serves every multi-rank case; the parent builds JAX's seeded
ResNet18 and ResNet50 KITTI models at 64x96 as tests/test_spatial.py
does, carries the weights across with the port's tools/torch_import,
and computes JAX's single-device forwards and the port's one-process
forwards while the ranks run. 64 rows over 8 ranks bands the image, the
encoder's H/2 and H/4 and the decoder's scales 0-2 (8, 4 and 2 rows a
band); H/8 and below are whole on every rank, so the stride-2 conv from
H/4 to H/8 gathers its input and the IDWT into H/4 slices its output.

Tolerances, each with its reason:
  * against JAX, disp and the LH coefficient 1e-5 (the contract of
    tests/test_spatial.py); the JAX encoder folds its input
    normalisation into the stem BN and the port does not, and XLA and
    ATen sum the convs in other orders, so these are float32 rounding
    apart, as the one-process parity tests find;
  * masks and op counts exactly, against JAX and against one process (a
    banded threshold reduces the same max and min; the counts take the
    global heights);
  * the kernel backends (their plain versions here) against the port's
    one-process forward on the same backend, floats 1e-5 plus 1e-5
    relative (a band's convs sum as the whole image's, but ATen may
    block a band's rows otherwise);
  * every rank returns the same full-height outputs, bitwise;
  * the halo rule, float64: 1e-12.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_spatial_worker as wk
from wavelet_monodepth_tpu.models.decoders_kitti import \
    KittiWaveletDecoder as JDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu_torch.parallel import spatial_hints as sh
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_spatial_worker.py")
TIMEOUT = 300          # seconds for the whole eight-rank launch
WORLD = 8
H, W = 64, 96
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_model(depth: int, x):
    """tests/test_spatial.py's model: both inits from PRNGKey(0)."""
    enc = JEncoder(num_layers=depth)
    dec = JDecoder(num_ch_enc=j_num_ch_enc(depth))
    rng = jax.random.PRNGKey(0)
    ev = enc.init(rng, x)
    dv = dec.init(rng, enc.apply(ev, x))
    return enc, dec, ev, dv


def _np(t):
    return np.asarray(t)


def _jax_references(models: dict, x) -> dict:
    """JAX's single-device forwards of the cases."""
    enc, dec, ev, dv = models[18]
    dense = dec.apply(dv, enc.apply(ev, x))
    sparse = dec.apply(dv, enc.apply(ev, x), thresh_ratio=wk.THRESH)
    x2 = jnp.concatenate([x, x[:, :, ::-1]], axis=0)
    enc50, dec50, ev50, dv50 = models[50]
    r50 = dec50.apply(dv50, enc50.apply(ev50, x))
    keys_dense = (("disp", 0), ("wavelets", 1, "LH"))
    return {
        "dense": {k: _np(dense[k]) for k in keys_dense},
        "sparse": {k: _np(sparse[k]) for k in
                   (("disp", 0), ("wavelet_mask", 1), ("total_ops", -1))},
        "mesh24": _np(dec.apply(dv, enc.apply(ev, x2))[("disp", 0)]),
        "r50": {k: _np(r50[k]) for k in keys_dense},
    }


def _port_references(inputs: dict) -> dict:
    """The port's one-process forwards on the kernel backends (their plain
    versions on the CPU)."""
    enc, dec = wk.build(18, inputs["enc18"], inputs["dec18"])
    with torch.no_grad():
        feats = enc(inputs["x"])
        return {b: dec(feats, thresh_ratio=wk.THRESH, use_pallas=b)
                for b in wk.SPARSE_BACKENDS if b != "xla"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results, JAX's and the one-process references."""
    tmp = tmp_path_factory.mktemp("spatial")
    x = jax.random.uniform(jax.random.PRNGKey(7), (1, H, W, 3), jnp.float32)
    models = {d: _jax_model(d, x) for d in (18, 50)}
    inputs = {"x": torch.from_numpy(np.array(x))}
    for d, (_, _, ev, dv) in models.items():
        inputs[f"enc{d}"], inputs[f"dec{d}"] = ti.state_dicts_from_jax(ev, dv)
    torch.save(inputs, tmp / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    logs = [open(tmp / f"log{r}.txt", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), str(tmp)],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL) for r in range(WORLD)]
    deadline = time.time() + TIMEOUT
    try:
        refs = _jax_references(models, x)
        ones = _port_references(inputs)
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, refs=refs, ones=ones)


def _close(ours: torch.Tensor, ref, atol=TOL, rtol=0.0, what=""):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=what)


def _same_on_every_rank(run, case: str, ranks=None):
    ranks = run["ranks"] if ranks is None else ranks
    first = ranks[0][case]
    for r in ranks[1:]:
        assert set(r[case]) == set(first)
        for k in first:
            assert torch.equal(r[case][k], first[k]), (case, k)


def test_spatial_dense_matches_jax(run):
    """1x8: every rank holds an 8-row band of the image and returns
    disp_0 and the scale-1 LH coefficient in full height, within 1e-5 of
    JAX's single-device forward."""
    assert [r["band_rows"] for r in run["ranks"]] == [H // WORLD] * WORLD
    for r in run["ranks"]:
        for k, ref in run["refs"]["dense"].items():
            assert r["dense"][k].shape == ref.shape, k
            _close(r["dense"][k], ref, what=str(k))
    _same_on_every_rank(run, "dense")


def test_spatial_sparse_matches_jax(run):
    """The threshold's max - min reduces across the bands: disp within
    1e-5 of JAX, the scale-1 wavelet mask and the total op count exactly
    JAX's."""
    ref = run["refs"]["sparse"]
    for r in run["ranks"]:
        out = r["sparse_xla"]
        _close(out[("disp", 0)], ref[("disp", 0)], what="disp 0")
        np.testing.assert_array_equal(out[("wavelet_mask", 1)].numpy(),
                                      ref[("wavelet_mask", 1)])
        np.testing.assert_array_equal(out[("total_ops", -1)].numpy(),
                                      ref[("total_ops", -1)])
    _same_on_every_rank(run, "sparse_xla")


def test_spatial_times_data_mesh(run):
    """2x4 from the same world: each data row bands its own image (B=2:
    the image and its mirror), within 1e-5 of JAX's batch."""
    ref = run["refs"]["mesh24"]
    rows = {}
    for r in run["ranks"]:
        d = r["data_index"]
        rows.setdefault(d, []).append(r)
        _close(r["mesh24"][("disp", 0)], ref[d:d + 1], what=f"row {d}")
    assert sorted(rows) == [0, 1]
    for d, ranks in rows.items():
        assert len(ranks) == WORLD // 2
        _same_on_every_rank(run, "mesh24", ranks)


@pytest.mark.parametrize("backend", ["pallas", "pallas2d", "compact"])
def test_spatial_kernel_backends_match_one_process(run, backend):
    """Each sparse scale gathers, runs the backend once on the whole
    image and keeps the band: the outputs equal the port's one-process
    forward on the same backend (held to JAX by the backend parity
    tests): masks, op counts and overflow exactly."""
    ref = run["ones"][backend]
    for r in run["ranks"]:
        out = r[f"sparse_{backend}"]
        assert set(out) == set(ref)
        for k, v in ref.items():
            assert out[k].shape == v.shape, k
            if k[0].endswith("mask") or k[0] in ("total_ops", "overflow"):
                assert torch.equal(out[k], v), k
            else:
                _close(out[k], v, rtol=TOL, what=str(k))
    _same_on_every_rank(run, f"sparse_{backend}")


def test_spatial_resnet50_dense_matches_jax(run):
    """Bottleneck blocks (1x1, 3x3 s2, 1x1, a 1x1 s2 shortcut) banded
    alike: ResNet50 at 1x8 within 1e-5 of JAX."""
    for r in run["ranks"]:
        for k, ref in run["refs"]["r50"].items():
            _close(r["r50"][k], ref, what=str(k))
    _same_on_every_rank(run, "r50")


# --- the halo rule, one process ----------------------------------------------

BANDS = 4
# (name, kernel, stride, pad, pad mode, the op on NCHW with H padding ph)
WINDOW_OPS = [
    ("conv3x3_s1", 3, 1, 1, "zero"),
    ("conv3x3_s2", 3, 2, 1, "zero"),
    ("stem7x7_s2", 7, 2, 3, "zero"),
    ("maxpool3_s2", 3, 2, 1, "-inf"),
    ("conv1x1_s1", 1, 1, 0, "zero"),
    ("conv1x1_s2", 1, 2, 0, "zero"),
    ("decoder3x3_reflect", 3, 1, 1, "reflect"),
    ("dilate3", 3, 1, 1, "-inf"),
    ("dilate5", 5, 1, 2, "-inf"),
]


def _window_op(name, k, s, p, mode, x, ph):
    """The op on NCHW x with ph rows of H padding (in its mode) and its
    own W padding; the convs' weights from a seed."""
    if mode == "-inf":
        return F.max_pool2d(x, k, s, (ph, p))
    w = torch.from_numpy(np.random.RandomState(k + s).randn(
        3, x.shape[1], k, k))
    if mode == "reflect":
        x = F.pad(x, (p, p, ph, ph), mode="reflect")
        return F.conv2d(x, w, stride=s)
    return F.conv2d(x, w, stride=s, padding=(ph, p))


@pytest.mark.parametrize("op", WINDOW_OPS, ids=[o[0] for o in WINDOW_OPS])
def test_halo_rule(op):
    """Each band between `halo`'s rows of its neighbours (or the op's own
    padding at the image border, `assemble`), run with no H padding,
    gives exactly its band of the whole image's output."""
    name, k, s, p, mode = op
    rows = 32
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 2, rows, 7))
    full = _window_op(name, k, s, p, mode, x, p)
    top, bottom = (max(h, 0) for h in sh.halo(k, s, p))
    expected = {"conv3x3_s1": (1, 1), "conv3x3_s2": (1, 0),
                "stem7x7_s2": (3, 2), "maxpool3_s2": (1, 0),
                "conv1x1_s1": (0, 0), "conv1x1_s2": (0, 0),
                "decoder3x3_reflect": (1, 1), "dilate3": (1, 1),
                "dilate5": (2, 2)}[name]
    assert (top, bottom) == expected
    b_in, b_out = rows // BANDS, full.shape[2] // BANDS
    for r in range(BANDS):
        band = x[:, :, r * b_in:(r + 1) * b_in]
        above = x[:, :, r * b_in - top:r * b_in] if r > 0 else None
        below = (x[:, :, (r + 1) * b_in:(r + 1) * b_in + bottom]
                 if r < BANDS - 1 else None)
        padded = sh.assemble(band, above, below, top, bottom, mode, dim=2)
        got = _window_op(name, k, s, p, mode, padded, 0)
        want = full[:, :, r * b_out:(r + 1) * b_out]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12, err_msg=f"{name} band {r}")


@pytest.mark.parametrize("lo", ["replicate", "zero"])
def test_polyphase_fold_halo(lo):
    """The polyphase fold's low-res 2x2 conv takes 1/1 rows, not
    `halo(2, 1, 1)`: each band of x0 between one row of each neighbour
    (at the image border x0's own padding: replicate under the reflect-
    and replicate-padded decoders, zero under DepthDecoder), padded along
    W, gives through the VALID conv and the interleave exactly its 2b
    rows of the whole fold's output."""
    from wavelet_monodepth_tpu_torch.ops import convops
    rng = np.random.RandomState(3)
    rows, co = 16, 3
    x0 = torch.from_numpy(rng.randn(1, rows, 5, 4))
    wc = convops._poly_collapse(torch.from_numpy(rng.randn(co, 4, 3, 3)))
    full = convops._poly_interleave(
        convops.conv2d(convops.pad2d(x0, 1, lo), wc), co)
    b = rows // BANDS
    for r in range(BANDS):
        above = x0[:, r * b - 1:r * b] if r > 0 else None
        below = x0[:, (r + 1) * b:(r + 1) * b + 1] if r < BANDS - 1 else None
        padded = sh.assemble(x0[:, r * b:(r + 1) * b], above, below, 1, 1,
                             lo)
        padded = F.pad(padded.permute(0, 3, 1, 2), (1, 1, 0, 0),
                       mode="constant" if lo == "zero" else lo)
        got = convops._poly_interleave(
            convops.conv2d(padded.permute(0, 2, 3, 1), wc), co)
        np.testing.assert_allclose(
            got.numpy(), full[:, 2 * r * b:2 * (r + 1) * b].numpy(), rtol=0,
            atol=1e-12, err_msg=f"band {r}")


@pytest.mark.parametrize("h0, ranks", [(64, 8), (64, 4), (192, 2),
                                       (320, 2)])
def test_stride2_ops_see_even_bands(h0, ranks):
    """Every stride-2 op of the encoder whose output is banded reads a
    banded input of an even number of rows a band, so the band's outputs
    are exactly its rows of the whole output; one whose output is whole
    gathers its input."""
    layout = sh.Layout(ranks, 0)
    seen = []
    for k in range(5):                          # the stem, pool, layer2-4
        rows_in, rows_out = h0 >> k, h0 >> (k + 1)
        if layout.banded(rows_out):
            assert layout.banded(rows_in)
            assert (rows_in // ranks) % 2 == 0
            seen.append(k)
    assert seen, "no banded stride-2 op at this size"


def test_layout_rule_and_refusals():
    """The band rule (JAX's: replicate under 2 rows a band; the port also
    replicates heights that do not divide), `hint`, `band_of` and
    `global_shape` under the `at_rows` scope, and the one refusal left
    under a spatial layout: a train-mode BN, since spatial inference is
    a forward. MobileNetV2, the baseline DepthDecoder and use_polyphase
    on the KITTI and NYU wavelet decoders run under a layout (a one-rank
    one here, bitwise equal to the plain forward; tests/
    test_torch_port_spatial_models.py bands them over eight ranks), as
    NyuDecoderWave does."""
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import (
        DepthDecoder, KittiWaveletDecoder)
    from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
        NyuDecoderWave
    from wavelet_monodepth_tpu_torch.models.mobilenetv2 import \
        MobileNetV2Encoder
    from wavelet_monodepth_tpu_torch.models.resnet import (BatchNorm2d,
                                                           num_ch_enc)
    layout = sh.Layout(2, 1)
    assert [layout.banded(h) for h in (2, 3, 4, 6, 10, 5)] == \
        [False, False, True, True, True, False]
    x = torch.arange(8.0).reshape(1, 8, 1, 1)
    assert sh.hint(x, 8) is x and sh.rows_of(x) == 8    # inactive
    with sh.active(layout):
        band = sh.hint(x, 8)
        assert band.flatten().tolist() == [4.0, 5.0, 6.0, 7.0]
        assert sh.rows_of(band) == 8
        assert sh.band_of(band) is None                 # no scope
        assert sh.hint(x) is x                          # no scope
        with sh.at_rows(8):
            assert sh.band_of(band) is layout
            assert sh.band_of(x) is None                # whole
            assert sh.global_shape(band) == sh.global_shape(x) == x.shape
            assert torch.equal(sh.hint(x), band)        # the scope's rows
            with sh.upsampled():
                assert sh.band_of(torch.zeros(1, 8, 1, 1)) is layout
            with sh.downsampled():
                assert sh.band_of(torch.zeros(1, 2, 1, 1)) is layout
        assert sh.global_shape(band) == band.shape      # no scope
        with pytest.raises(ValueError, match="neither"):
            layout.is_band(x[:, :3], 8)
        with pytest.raises(NotImplementedError,
                           match="train-mode BatchNorm .*is a forward"):
            BatchNorm2d(4).train()(torch.zeros(2, 4, 2, 2))
    rng = np.random.RandomState(0)
    feats = [torch.from_numpy(rng.rand(1, 32 // 2 ** i, 48 // 2 ** i, c)
                              .astype(np.float32))
             for i, c in enumerate(num_ch_enc(18))]
    nyu_ch = (16, 24, 32, 64, 1280)
    nyu_feats = [torch.from_numpy(np.random.RandomState(i).rand(
        1, 32 // 2 ** i, 48 // 2 ** i, c).astype(np.float32))
        for i, c in enumerate(nyu_ch)]
    image = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32))
    cases = (
        (NyuDecoderWave(nyu_ch), lambda m: m(nyu_feats, thresh_ratio=0.05)),
        (DepthDecoder(num_ch_enc(18)), lambda m: m(feats)),
        (DepthDecoder(num_ch_enc(18), use_polyphase=True),
         lambda m: m(feats)),
        (KittiWaveletDecoder(num_ch_enc(18), use_polyphase=True),
         lambda m: m(feats, thresh_ratio=0.05)),
        (NyuDecoderWave(nyu_ch, use_polyphase=True),
         lambda m: m(nyu_feats, thresh_ratio=0.05)),
        (MobileNetV2Encoder(),
         lambda m: dict(enumerate(m(image)))))
    for model, call in cases:
        model.eval()
        with torch.no_grad():
            plain = call(model)
            with sh.active(sh.Layout(1, 0)):
                banded = call(model)
        assert set(banded) == set(plain), type(model).__name__
        for k, v in plain.items():
            assert torch.equal(banded[k], v), (type(model).__name__, k)
