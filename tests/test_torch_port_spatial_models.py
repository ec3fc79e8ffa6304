"""Port parity, spatial (image-height) inference of the models that the
other spatial tests leave out: MobileNetV2 (the KITTI `mobilenet` and
`mobilenet_light` encoders, the NYU `mobilenet` encoder), the baseline
DepthDecoder and `use_polyphase` on the KITTI and NYU decoders, under
`mesh.spatial_forward`, eight gloo ranks on the CPU against JAX's
single-device forward of the same flax models.

One launch of tests/torch_spatial_models_worker.py (eight processes, one
thread each) serves every case, as in tests/test_torch_port_spatial.py.
The parent draws JAX's weights as seeded numpy trees of the inits'
shapes (tests/test_torch_port_nyu_models.py's `random_vars`), carries
them across with the port's tools/torch_import, and computes JAX's
forwards and the port's one-process forwards while the ranks run. The
KITTI decoders threshold at 0.1 and NYU's at 0.05, NYU's wave heads
scaled by HEAD_SCALE: there the seeded models' masks are partial at the
two finest scales.

64 rows over 8 ranks bands the image, the encoders' H/2 and H/4 and the
decoders' scales at those heights (8, 4 and 2 rows a band); H/8 and
below are whole on every rank. So MobileNetV2's stride-2 depthwise conv
from H/4 to H/8 gathers its input, and the polyphase fold runs both of
its ways: whole and sliced from H/8 into H/4, in bands from H/4 into
H/2.

Tolerances, each with its reason:
  * every case runs twice, in float64 and in float32. In float64 it is
    held to JAX's single-device forward under x64: every disp scale
    within 1e-5 (tests/test_spatial.py's limit; the gap is ~1e-13),
    masks and op counts exactly; and to the port's one-process float64
    forward, every float output within 1e-9 (the bands sum each conv as
    the whole image does: ~1e-13). In float32 these seeded N(0, 2 /
    fan_in) models round ~2e-5 relative to their outputs' size apart
    between a band's convs and the whole image's (ATen blocks other
    shapes otherwise), as far as their one-process forward is from
    XLA's; so float32 is held to the one-process float32 forward within
    1e-4 of max(1, max |output|) per output (chip_smoke's NYU contract),
    masks and op counts exactly;
  * the kernel backends (their float32 plain versions here) likewise
    against the one-process forward on the same backend, with each
    kernel wrapper's calls and their full heights;
  * every rank returns the same full-height outputs, bitwise.
"""

import os
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

import torch_spatial_models_worker as wk
from test_torch_port_nyu_models import random_vars
from wavelet_monodepth_tpu.models import decoders_kitti as jdk
from wavelet_monodepth_tpu.models import decoders_nyu as jdn
from wavelet_monodepth_tpu.models.mobilenetv2 import \
    MobileNetV2Encoder as JMobile
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JResnet
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from torch_tmp import drop_module_tmp  # noqa: E402,F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_spatial_models_worker.py")
TIMEOUT = 300          # seconds for the whole eight-rank launch
WORLD = 8
H, W = 64, 96
TOL = 1e-5             # disp against JAX, float64
F64_TOL = 1e-9         # every output against one process, float64
F32_REL = 1e-4         # every output against one process, float32
HEAD_SCALE = 0.05
KEEP = ("disp", "wavelet_mask", "total_ops")

J_ENCODERS = {"mbv2": lambda: JMobile(use_last_layer=True),
              "mbv2_light": lambda: JMobile(use_last_layer=False),
              "r18": lambda: JResnet(num_layers=18)}
J_DECODERS = {"decoders_kitti": jdk, "decoders_nyu": jdn}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _quiet_heads(dv: dict) -> dict:
    """NYU's wave heads' (wave1..3) kernels and biases x HEAD_SCALE, for
    partial masks; the KITTI decoders' as drawn."""
    for name in ("wave1", "wave2", "wave3"):
        head = dv["params"].get(name, {})
        for p in ("kernel", "bias"):
            if p in head:
                head[p] = head[p] * HEAD_SCALE
    return dv


def _j_decoder(model: str, opts: dict):
    mod, cls = wk.MODELS[model][1].split(".")
    return getattr(J_DECODERS[mod], cls)(num_ch_enc=_j_channels(model),
                                         **opts)


def _j_channels(model: str) -> tuple:
    from wavelet_monodepth_tpu.models.mobilenetv2 import num_ch_enc as mch
    from wavelet_monodepth_tpu.models.resnet import num_ch_enc as rch
    enc = wk.MODELS[model][0]
    return rch(18) if enc == "r18" else mch(enc == "mbv2")


def _jax_models(x) -> dict:
    """{model: (JAX encoder, its variables, the decoder's variables)},
    each model on weights of its own seed."""
    models = {}
    for seed, model in enumerate(wk.MODELS):
        jenc = J_ENCODERS[wk.MODELS[model][0]]()
        ev = random_vars(jenc.init, x, seed=10 + 2 * seed)
        shapes = jax.eval_shape(jenc.apply, ev, x)
        dv = _quiet_heads(random_vars(_j_decoder(model, {}).init, shapes,
                                      seed=11 + 2 * seed))
        models[model] = (jenc, ev, dv)
    return models


def _jax_references(models: dict, x) -> dict:
    """JAX's single-device forward of every case in float64 (x64): disp,
    masks and op counts."""
    refs = {}
    f64 = partial(jax.tree_util.tree_map,
                  lambda v: np.asarray(v, np.float64))
    with jax.enable_x64(True):
        for case, (model, opts, kw) in wk.CASES.items():
            jenc, ev, dv = models[model]
            jd = _j_decoder(model, opts)
            out = jax.jit(lambda e, d, im: jd.apply(d, jenc.apply(e, im),
                                                    **kw))(
                f64(ev), f64(dv), jnp.asarray(x, jnp.float64))
            refs[case] = {k: np.asarray(v) for k, v in out.items()
                          if k[0] in KEEP}
    return refs


def _port_references(inputs: dict) -> dict:
    """The port's one-process forward of every run of the worker (the
    kernels' plain versions on the CPU)."""
    ones = {}
    with torch.no_grad():
        for key, case, dtype in wk.runs():
            enc, dec = wk.build(case, inputs, dtype)
            ones[key] = dec(enc(inputs["x"].to(dtype)),
                            **wk.forward_kwargs(case))
    return ones


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results, JAX's and the one-process references."""
    tmp = tmp_path_factory.mktemp("spatial_models")
    x = np.random.RandomState(0).rand(1, H, W, 3).astype(np.float32)
    models = _jax_models(jnp.asarray(x))
    inputs = {"x": torch.from_numpy(x)}
    for model, (_, ev, dv) in models.items():
        enc_sd, dec_sd = ti.state_dicts_from_jax(ev, dv)
        inputs[model] = {"enc": enc_sd, "dec": dec_sd}
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


def _exact(k) -> bool:
    return k[0].endswith("mask") or k[0] in ("total_ops", "overflow")


def _same_on_every_rank(run, case: str):
    first = run["ranks"][0][case]
    for r in run["ranks"][1:]:
        assert set(r[case]) == set(first)
        for k in first:
            assert torch.equal(r[case][k], first[k]), (case, k)


def _matches_one_process(run, key: str, rel: float):
    """Every rank's outputs of run `key` against the port's one-process
    forward: each float output within `rel` of max(1, max |output|),
    masks and counts exactly; and every rank's equal, bitwise."""
    ref = run["ones"][key]
    for r in run["ranks"]:
        out = r[key]
        assert set(out) == set(ref), key
        for k, v in ref.items():
            assert out[k].shape == v.shape, (key, k)
            if _exact(k):
                assert torch.equal(out[k], v), (key, k)
            else:
                lim = rel * max(1.0, float(v.abs().max()))
                np.testing.assert_allclose(out[k].numpy(), v.numpy(),
                                           atol=lim, rtol=0,
                                           err_msg=str((key, k)))
    _same_on_every_rank(run, key)


@pytest.mark.parametrize("case", list(wk.CASES))
def test_case_matches_jax(run, case):
    """Float64: every rank's disp of each scale within 1e-5 of JAX's
    single-device forward, its masks and op counts exactly JAX's (the
    sparse masks partial at the two finest scales), every output within
    1e-9 of max(1, max |output|) of the port's one-process forward,
    every rank's the same."""
    assert [r["band_rows"] for r in run["ranks"]] == [H // WORLD] * WORLD
    ref = run["refs"][case]
    assert any(k[0] == "disp" for k in ref)
    for r in run["ranks"]:
        out = r[f"{case}64"]
        assert {k for k in out if k[0] in KEEP} == set(ref), case
        for k, v in ref.items():
            assert tuple(out[k].shape) == v.shape, (case, k)
            assert out[k].dtype == (torch.float32 if k[0] == "total_ops"
                                    else torch.float64), (case, k)
            if _exact(k):
                np.testing.assert_array_equal(out[k].numpy(), v,
                                              err_msg=str((case, k)))
            else:
                np.testing.assert_allclose(out[k].numpy(), v, atol=TOL,
                                           rtol=0, err_msg=str((case, k)))
    if "thresh_ratio" in wk.CASES[case][2]:
        for s in (0, 1):
            d = float(ref[("wavelet_mask", s)].mean())
            assert 0.0 < d < 1.0, (case, s, d)
    _matches_one_process(run, f"{case}64", F64_TOL)


@pytest.mark.parametrize("case", list(wk.CASES))
def test_case_float32_matches_one_process(run, case):
    """Float32: every rank's outputs within 1e-4 of max(1, max |output|)
    of the port's one-process forward, masks and op counts exactly,
    every rank's the same."""
    _matches_one_process(run, case, F32_REL)
    assert run["ranks"][0][case][("disp", 0)].dtype == torch.float32


# the kernel wrappers each kernel case's sparse forward calls, in order,
# with their inputs' heights: the KITTI decoder's four convs per sparse
# scale (upconv_i_0 at the low height, upconv_i_1 and the two heads at
# the high one) for scales 3 (H/16 -> H/8), 2 (-> H/4) and 1 (-> H/2);
# NYU's up2.convA, wave2, up3.convA, wave3 (H/8, then H/4), the convAs
# on the backend, the heads on K1
_KITTI = [(H // 16, H // 8), (H // 8, H // 4), (H // 4, H // 2)]
CALLS = {
    f"kitti_mbv2_{b}": [(f"conv3x3_tile_sparse{sfx}", h)
                        for lo, hi in _KITTI
                        for h in (lo, hi, hi, hi)]
    for b, sfx in (("pallas", ""), ("pallas2d", "_2d"))}
CALLS.update({
    "nyu_mbv2_pallas": [("conv3x3_tile_sparse", h)
                        for h in (H // 8,) * 2 + (H // 4,) * 2],
    "nyu_mbv2_pallas2d": [(name, h) for h in (H // 8, H // 4) for name in
                          ("conv3x3_tile_sparse_2d",
                           "conv3x3_tile_sparse")]})


@pytest.mark.parametrize("case", list(wk.KERNEL_CASES))
def test_kernel_backend_matches_one_process(run, case):
    """MobileNetV2 with the KITTI and NYU wavelet decoders on the kernel
    backends: each conv that reaches K1 or K4 runs once on the whole
    image on every rank (its calls recorded with their full heights),
    and the outputs equal the port's one-process forward on the same
    backend as float32 does above, masks and op counts exactly."""
    for r in run["ranks"]:
        assert r["calls"][case] == CALLS[case]
    _matches_one_process(run, case, F32_REL)
