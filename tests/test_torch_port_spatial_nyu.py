"""Port parity, spatial (image-height) inference of the NYU models:
DenseNet161 and the NYU decoders under `mesh.spatial_forward`, eight
gloo ranks on the CPU against JAX's single-device forward and the
port's one-process forward.

One launch of tests/torch_spatial_nyu_worker.py (eight processes, one
thread each) serves every multi-rank case, as in
tests/test_torch_port_spatial.py. The parent draws JAX's DenseNet161 +
NyuDecoderWave weights as seeded numpy trees of `jax.eval_shape` of the
init (tests/test_torch_port_nyu_models.py's `random_vars`: an eager flax
init of DenseNet161 takes over a minute), carries them across with the
port's tools/torch_import, and computes JAX's forwards and the port's
one-process forwards while the ranks run. The Conv3x3 wave heads'
weights and biases are scaled by 0.05 so that the masks at threshold
0.05 are partial at both sparse scales.

128 rows over 8 ranks bands the encoder's and the decoder's H/2, H/4 and
H/8 (8, 4 and 2 rows a band); H/16 and below are whole on every rank, so
transition 2 gathers its input, denseblock3 and denseblock4 run whole,
and both sparse scales (thresholded at H/16 and H/8) are banded. The
narrow decoders take full-height features of the same pyramid and band
them inside their forward.

Tolerances, each with its reason:
  * against JAX, every disp scale 1e-5 (tests/test_spatial.py's limit).
    DenseNet161 + NyuDecoderWave is held to JAX in float64 (JAX under
    x64): in float32 a band's convs round otherwise than the whole
    image's (ATen blocks other shapes otherwise), which moves the disp
    of ~2.5 by up to ~1e-5 against the one-process forward, as far as
    XLA's sums are from ATen's; in float64 the bands equal the
    one-process forward to ~5e-15. The narrow decoders are held to JAX
    in float32;
  * masks and op counts exactly, against JAX and against one process (a
    banded threshold reduces the same max and min; the counts take the
    global heights);
  * the kernel backends (their plain versions here) against the port's
    one-process forward on the same backend, floats 1e-5 plus 1e-5
    relative (each banded conv sums as the whole image's, but ATen may
    block a band's rows otherwise);
  * every rank returns the same full-height outputs, bitwise.
"""

import os
import shutil
import socket
import subprocess
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_spatial_nyu_worker as wk
from test_torch_port_nyu_models import CH, random_vars
from wavelet_monodepth_tpu.models import decoders_nyu as jdec
from wavelet_monodepth_tpu.models.densenet import DenseNet161Encoder as JDense
from wavelet_monodepth_tpu_torch.parallel import spatial_hints as sh
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_spatial_nyu_worker.py")
TIMEOUT = 240          # seconds for the whole eight-rank launch
WORLD = 8
H, W = 128, 96
NARROW_N = 2
TOL = 1e-5
HEAD_SCALE = 0.05
HEADS = ("wave1", "wave2", "wave3")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np(t):
    return np.asarray(t)


def _quiet_heads(dv: dict) -> dict:
    """The Conv3x3 wave heads' kernels and biases x HEAD_SCALE (partial
    masks; the depthwise heads give partial masks as drawn)."""
    for k in HEADS:
        head = dv["params"].get(k, {})
        for p in ("kernel", "bias"):
            if p in head:
                head[p] = head[p] * HEAD_SCALE
    return dv


def _jax_models(x):
    """JAX's DenseNet161 + NyuDecoderWave variables, and the narrow
    decoders with their full-height features."""
    jenc = JDense()
    ev = random_vars(jenc.init, x, seed=1)
    shapes = jax.eval_shape(jenc.apply, ev, x)
    jd = jdec.NyuDecoderWave(num_ch_enc=(96, 96, 192, 384, 2208))
    dv = _quiet_heads(random_vars(jd.init, shapes, seed=2))
    rng = np.random.RandomState(5)
    feats = [rng.randn(NARROW_N, H // 2 ** (i + 1), W // 2 ** (i + 1), c)
             .astype(np.float32) for i, c in enumerate(CH)]
    narrow = {}
    for name, (cls, opts, _) in wk.DECODERS.items():
        m = getattr(jdec, cls)(num_ch_enc=CH, **opts)
        v = _quiet_heads(random_vars(m.init, [jnp.asarray(f) for f in feats],
                                     seed=6))
        narrow[name] = (m, v)
    return (jenc, ev, jd, dv), narrow, feats


def _jax_references(models, narrow, feats, x) -> dict:
    """JAX's single-device forwards of the cases: DenseNet161 +
    NyuDecoderWave in float64, the narrow decoders in float32."""
    jenc, ev, jd, dv = models
    keep = ("disp", "wavelet_mask", "total_ops")
    f64 = partial(jax.tree_util.tree_map,
                  lambda v: np.asarray(v, np.float64))
    with jax.enable_x64(True):
        fwd = jax.jit(lambda e, d, im, **kw: jd.apply(d, jenc.apply(e, im),
                                                      **kw),
                      static_argnames=("thresh_ratio",))
        args = (f64(ev), f64(dv), jnp.asarray(x, jnp.float64))
        refs = {"dense64": fwd(*args),
                "sparse64": fwd(*args, thresh_ratio=wk.THRESH)}
        refs = {case: {k: _np(t) for k, t in out.items() if k[0] in keep}
                for case, out in refs.items()}
    jf = [jnp.asarray(f) for f in feats]
    for name, (m, v) in narrow.items():
        refs[name] = {k: _np(t) for k, t in m.apply(
            v, jf, **wk.DECODERS[name][2]).items() if k[0] in keep}
    return refs


def _port_references(inputs: dict) -> dict:
    """The port's one-process float32 forwards, dense and on every sparse
    backend (the kernels' plain versions on the CPU)."""
    enc, dec = wk.build(inputs)
    with torch.no_grad():
        feats = enc(inputs["x"])
        ones = {f"sparse_{b}": dec(feats, thresh_ratio=wk.THRESH,
                                   use_pallas=b) for b in wk.BACKENDS}
        ones["dense"] = dec(feats)
        return ones


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results, JAX's and the one-process references."""
    tmp = tmp_path_factory.mktemp("spatial_nyu")
    x = np.random.RandomState(0).rand(1, H, W, 3).astype(np.float32)
    models, narrow, feats = _jax_models(jnp.asarray(x))
    enc_sd, dec_sd = ti.state_dicts_from_jax(models[1], models[3])
    inputs = {"x": torch.from_numpy(x), "enc": enc_sd, "dec": dec_sd,
              "narrow_ch": CH,
              "narrow_feats": [torch.from_numpy(f) for f in feats],
              "narrow": {name: ti.state_dicts_from_jax(None, v)[1]
                         for name, (_, v) in narrow.items()}}
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
        refs = _jax_references(models, narrow, feats, x)
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
                               rtol=rtol, err_msg=str(what))


def _exact(k) -> bool:
    return k[0] in ("wavelet_mask", "total_ops")


def _same_on_every_rank(run, case: str):
    first = run["ranks"][0][case]
    for r in run["ranks"][1:]:
        assert set(r[case]) == set(first)
        for k in first:
            assert torch.equal(r[case][k], first[k]), (case, k)


def _matches_jax(run, case: str):
    """Every rank's disp, masks and op counts of `case` against JAX's:
    disp within TOL, masks and counts exactly, shapes equal."""
    ref = run["refs"][case]
    for r in run["ranks"]:
        out = r[case]
        assert {k for k in out if k[0] in ("disp", "wavelet_mask",
                                           "total_ops")} == set(ref), case
        for k, v in ref.items():
            assert tuple(out[k].shape) == v.shape, (case, k)
            if _exact(k):
                np.testing.assert_array_equal(out[k].numpy(), v,
                                              err_msg=str((case, k)))
            else:
                _close(out[k], v, what=(case, k))
    _same_on_every_rank(run, case)


def _matches_one_process(run, case: str):
    """Every rank's float32 outputs of `case` against the port's
    one-process forward: floats within TOL + TOL relative, masks and
    counts exactly."""
    ref = run["ones"][case]
    for r in run["ranks"]:
        out = r[case]
        assert set(out) == set(ref), case
        for k, v in ref.items():
            assert out[k].shape == v.shape, (case, k)
            if _exact(k):
                assert torch.equal(out[k], v), (case, k)
            else:
                _close(out[k], v, rtol=TOL, what=(case, k))
    _same_on_every_rank(run, case)


def test_densenet_wave_dense_matches_jax(run):
    """1x8: every rank holds a 16-row band of the image and returns each
    disp scale in full height: in float64 within 1e-5 of JAX's
    single-device DenseNet161 + NyuDecoderWave, in float32 within 1e-5 +
    1e-5 relative of the one-process forward."""
    assert [r["band_rows"] for r in run["ranks"]] == [H // WORLD] * WORLD
    assert sorted(k[1] for k in run["refs"]["dense64"]) == [0, 1, 2, 3]
    assert run["ranks"][0]["dense64"][("disp", 0)].dtype == torch.float64
    _matches_jax(run, "dense64")
    _matches_one_process(run, "dense")


def test_densenet_wave_sparse_xla_matches_jax(run):
    """Sparse at 0.05 on the masked-dense backend: the threshold's max
    and min reduce across the bands, so the partial masks and the total
    op count are exactly JAX's and disp within 1e-5 (float64); float32
    equals the one-process forward, masks and counts exactly."""
    for s in (0, 1):
        d = float(run["refs"]["sparse64"][("wavelet_mask", s)].mean())
        assert 0.0 < d < 1.0, (s, d)
    _matches_jax(run, "sparse64")
    _matches_one_process(run, "sparse_False")
    assert not run["ranks"][0]["calls"][False]


# the kernel wrappers each backend's sparse forward calls, in order:
# up2.convA, wave2, up3.convA, wave3 (JAX's routing: the convAs take the
# backend, the wave heads K1 for any truthy use_pallas)
CALLS = {
    True: ["conv3x3_tile_sparse"] * 4,
    "pallas2d": ["conv3x3_tile_sparse_2d", "conv3x3_tile_sparse"] * 2,
    "capacity": ["conv3x3_capacity_sparse", "conv3x3_tile_sparse"] * 2,
}


@pytest.mark.parametrize("backend", [True, "pallas2d", "capacity"])
def test_densenet_wave_kernel_backends_match_one_process(run, backend):
    """Each conv that reaches K1, K4 or capacity gathers its input, runs
    once on the whole image (H/8, then H/4 rows) on every rank and keeps
    the band: the outputs equal the port's one-process forward on the
    same backend, masks and op counts exactly."""
    for r in run["ranks"]:
        assert [c[0] for c in r["calls"][backend]] == CALLS[backend]
        assert [c[1] for c in r["calls"][backend]] == \
            [H // 8] * 2 + [H // 4] * 2
    _matches_one_process(run, f"sparse_{backend}")


@pytest.mark.parametrize("name", list(wk.DECODERS))
def test_narrow_decoders_match_jax(run, name):
    """The NYU decoders (dense baseline and its depthwise and 224
    variants, the wavelet decoders, the depthwise wavelet decoder dense
    and sparse) on narrow full-height features at B=2, banded inside the
    forward: within 1e-5 of JAX, masks and op counts exactly."""
    _matches_jax(run, name)
    if "thresh_ratio" in wk.DECODERS[name][2]:
        for s in (0, 1):
            d = float(run["refs"][name][("wavelet_mask", s)].mean())
            assert 0.0 < d < 1.0, (name, s, d)


# --- one process -----------------------------------------------------------

BANDS = 4


@pytest.mark.parametrize("rows", [32, 120])
def test_avg_pool_bands_without_halo(rows):
    """avg_pool2d(2, 2) has no halo: on even bands each rank's pool of its
    own rows is exactly its band of the whole image's pool (no
    communication, so one process plays every rank)."""
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 3, rows, 5))
    full = F.avg_pool2d(x, 2, 2)
    b = rows // BANDS
    assert sh.halo(2, 2, 0) == (0, 0) and b % 2 == 0
    for r in range(BANDS):
        with sh.active(sh.Layout(BANDS, r)):
            y, out_rows = sh.avg_pool2d(x[:, :, r * b:(r + 1) * b], rows)
            assert out_rows == rows // 2 and sh.rows_of(y, 2) == rows // 2
        assert torch.equal(y, full[:, :, r * b // 2:(r + 1) * b // 2]), r


@pytest.mark.parametrize("h0, ranks", [(128, 8), (480, 2)])
def test_densenet_downsamplings_see_even_bands(h0, ranks):
    """DenseNet161's five downsamplings (stem conv, stem pool, three
    transitions): each one whose output is banded reads a banded input
    of an even number of rows a band, so its band is exactly its rows of
    the whole output; one whose output is whole gathers. At 640x480 over
    two ranks, transition 3 (30 -> 15 rows) gathers and denseblock4 runs
    whole."""
    layout = sh.Layout(ranks, 0)
    whole = []
    for k in range(5):
        rows_in, rows_out = h0 >> k, h0 >> (k + 1)
        if layout.banded(rows_out):
            assert layout.banded(rows_in)
            assert (rows_in // ranks) % 2 == 0
        else:
            whole.append(k)
    assert whole == ({128: [3, 4], 480: [4]}[h0])


def test_phase_ab_refuses_without_a_card(tmp_path):
    """tools/phase_ab.py, which times chip_smoke's phases 21-22 (the
    spatial forwards among them) across trees, needs a card: its run of a
    tree fails, and it prints no summary."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    script = os.path.join(REPO, "wavelet_monodepth_tpu_torch", "tools",
                          "phase_ab.py")
    proc = subprocess.run([sys.executable, script, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "is_available() is False" in proc.stderr
    assert "exited with" in proc.stderr
    assert "phase_ab_summary" not in proc.stdout
