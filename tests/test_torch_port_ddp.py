"""Port parity, data-parallel training (`parallel/mesh.py`): two gloo
ranks on the CPU against one process on the global batch, and against
the JAX package.

One launch of tests/torch_ddp_worker.py (two processes) serves every
case; the parent computes the one-process references and JAX's
forward while the ranks run. The global batch is the ranks' rows in rank
order (B=4, 2 rows per rank); the port's one-process step on it is the
reference.

The KITTI step runs in float32 and in float64. At this size the float32
gradient is far from exact (the port's float32 gradients lie 0.2-3.5%
from its float64 ones, tests/test_torch_port_train.py), so two float32
runs that only sum in another order differ by up to ~1% in a gradient,
and Adam's first step (lr * sign for every gradient above its eps)
carries such differences into step 2. float64 holds the two-rank step
to the one-process step where float32 rounding cannot.

Tolerances, each with its reason:
  * the two ranks' parameters, Adam moments and BN statistics: bitwise
    equal (both apply one all-reduced gradient and global statistics);
  * float32, step 1: losses 1e-5 relative, two ranks vs one process and
    vs JAX's single-process forward on the same global batch and
    weights (float32 sums in another order; the parity test's 1e-5);
    each gradient tensor within 3x the one-process float32 gradient's
    own distance to the float64 one (plus 1e-6 of its norm); BN running
    statistics 1e-5 relative;
  * float64, both steps: losses 1e-6 relative (the port returns them as
    float32), gradients, BN statistics and the parameters after both
    steps within 1e-9 of each tensor's norm plus 1e-10 (running means of
    order 1e-12 where a BN follows a zero-mean input);
  * BatchNorm2d alone: outputs, input gradients and running statistics
    within 1e-6 (float32 values of order 1);
  * the ratio case (float64): as float64 above, and the average of the
    two halves' own losses (what ranks that average local ratios would
    log) lies more than 1e-3 relative away;
  * NYU (float64, two steps): as float64 above;
  * losses_nyu: values 1e-5 relative, gradients 1e-4 relative (float32):
    a rank's input gradient of a global loss is R times the global
    loss's (mesh.global_sum's backward sums the R ranks' seeds; the step
    divides the parameters' by R), so it is compared divided by R;
  * the bf16 mixed-precision step: 1e-3 relative (bfloat16 networks:
    one rounding of a BN output moves a loss by ~1e-4).
"""

import io
import os
import socket
import subprocess
import sys
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_ddp_worker as wk
from test_torch_port_data import write_mount
from wavelet_monodepth_tpu.parallel import mesh as jmesh
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.train.kitti import KittiTrainSetup as JSetup
from wavelet_monodepth_tpu.utils.config import KittiOptions as JOptions
from wavelet_monodepth_tpu_torch.parallel import mesh
from wavelet_monodepth_tpu_torch.tools import train_kitti, train_nyu

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")
TIMEOUT = 300          # seconds for the whole two-rank launch
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_nyu_zip(path, n=4):
    rng = np.random.RandomState(3)
    lines = []
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(n):
            for name, arr in (
                    (f"data/img_{i}.png",
                     rng.randint(0, 255, (480, 640, 3), dtype=np.uint8)),
                    (f"data/dep_{i}.png",
                     (rng.rand(480, 640) * 255).astype(np.uint8))):
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "PNG")
                zf.writestr(name, buf.getvalue())
            lines.append(f"data/img_{i}.png,data/dep_{i}.png")
        zf.writestr("data/nyu2_train.csv", "\n".join(lines))


def _jax_noise(steps=2) -> dict:
    """JAX's automask draws for the global batch, per step (key i) and
    scale, split as its forward splits them."""
    out = {}
    for i in range(steps):
        rng = jax.random.PRNGKey(i)
        for s in range(4):
            rng, sub = jax.random.split(rng)
            out[f"noise_{i}_{s}"] = np.array(
                jax.random.normal(sub, (wk.N, wk.H, wk.W, 1), jnp.float32))
    return out


def _jax_first_losses(setup) -> dict:
    """JAX's training forward on the global batch, from the port's
    conditioned weights read by the JAX package's importers, key 0."""
    from wavelet_monodepth_tpu.ops import augment as jaug
    state = wk.conditioned_state(setup)
    np_sd = {k: v.detach().numpy() for k, v in
             state.encoder.state_dict().items()}
    ev = jti.import_resnet_encoder(np_sd, 18)
    dv = jti.import_kitti_wavelet_decoder(
        {k: v.detach().numpy() for k, v in
         state.decoder.state_dict().items()})
    jsetup = JSetup(JOptions(**wk.KITTI), steps_per_epoch=10)

    @jax.jit
    def forward(params, stats, inputs, r):
        inputs = jaug.expand_batch(inputs, jnp)
        return jsetup.forward(params, stats, inputs, r, train=True)[1]

    losses = forward({"encoder": ev["params"], "depth": dv["params"]},
                     {"encoder": ev["batch_stats"]},
                     {k: jnp.asarray(v) for k, v in wk.kitti_batch().items()},
                     jax.random.PRNGKey(0))
    return {k: float(v) for k, v in jax.device_get(losses).items()}


def _references(noise) -> dict:
    """The one-process runs of every case (rank 0 of 1), the halves of
    the ratio case on their own (rank r of 2 without a group: local
    statistics and ratios), and JAX's first losses."""
    f64 = torch.float64
    refs = {"kitti": wk.kitti_steps(wk.kitti_setup(), wk.kitti_batch(),
                                    noise, 0, 1),
            "kitti64": wk.kitti_steps(wk.kitti_setup(), wk.kitti_batch(),
                                      noise, 0, 1, f64),
            "ratio": wk.kitti_steps(wk.kitti_setup(),
                                    wk.kitti_batch(few_hints_from=2),
                                    noise[:1], 0, 1, f64),
            "ratio_halves": [wk.kitti_steps(
                wk.kitti_setup(), wk.kitti_batch(few_hints_from=2),
                noise[:1], r, WORLD, f64)["losses"][0]
                for r in range(WORLD)],
            "bf16": wk.kitti_steps(wk.kitti_setup(bfloat16=True),
                                   wk.kitti_batch(), noise[:1], 0, 1),
            "bn": wk.bn_case(0, 1), "nyu": wk.nyu_steps(0, 1),
            "nyu_bf16": wk.nyu_steps(0, 1, 1, torch.bfloat16),
            "nyu_losses": wk.nyu_losses_case(0, 1)}
    refs["jax"] = _jax_first_losses(wk.kitti_setup())
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results and the references."""
    tmp = tmp_path_factory.mktemp("ddp")
    noise = _jax_noise()
    np.savez(tmp / "inputs.npz", **noise)
    write_mount(str(tmp / "kitti"), 8, 75, 124)
    _write_nyu_zip(tmp / "nyu_data.zip")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    logs = [open(tmp / f"log{r}.txt", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), str(tmp)],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL) for r in range(WORLD)]
    deadline = time.time() + TIMEOUT
    try:
        refs = _references(wk.noise_steps(str(tmp / "inputs.npz")))
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
    return dict(ranks=ranks, refs=refs, tmp=tmp)


def _rows(t, r):
    n = wk.N // WORLD
    return t[r * n:(r + 1) * n]


def _assert_losses(ours, ref, rtol=1e-5):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, err_msg=k)


def _assert_rel(ours: dict, ref: dict, tol: float, atol: float = 1e-12):
    assert set(ours) == set(ref)
    for k in ref:
        err = float((ours[k] - ref[k]).norm())
        assert err <= tol * float(ref[k].norm()) + atol, (k, err)


def _assert_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_ranks_hold_equal_state(run):
    """(a) after two steps the ranks' parameters, Adam moments and BN
    statistics are bitwise equal, and they moved from the start."""
    r0, r1 = (r["kitti"] for r in run["ranks"])
    _assert_equal(r0["params"], r1["params"])
    _assert_equal(r0["stats"], r1["stats"])
    assert len(r0["adam"]) == len(r1["adam"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(r0["adam"], r1["adam"]))
    moved = [k for k in r0["params"]
             if not torch.equal(r0["params"][k], r0["params0"][k])]
    assert len(moved) == len(r0["params"])
    for case in ("kitti64", "ratio", "nyu", "bf16", "nyu_bf16"):
        _assert_equal(run["ranks"][0][case]["params"],
                      run["ranks"][1][case]["params"])


def test_two_ranks_equal_one_process(run):
    """(b) float32: step 1's losses, averaged gradients and BN statistics
    equal the one-process step on the global batch; float64: both steps'
    losses, step 1's gradients and BN statistics and the parameters
    after."""
    ref, g64 = run["refs"]["kitti"], run["refs"]["kitti64"]["grads"]
    for r in run["ranks"]:
        _assert_losses(r["kitti"]["losses"][0], ref["losses"][0])
        _assert_rel(r["kitti"]["stats"], ref["stats"], 1e-5)
        for k, g in r["kitti"]["grads"].items():
            scale = float(g64[k].norm())
            e_ours = float((g.double() - g64[k]).norm())
            e_one = float((ref["grads"][k].double() - g64[k]).norm())
            assert e_ours <= 3 * e_one + 1e-6 * scale, (k, e_ours, e_one)
    _assert_float64_equal(run, "kitti64")


def _assert_float64_equal(run, case):
    ref = run["refs"][case]
    for r in run["ranks"]:
        assert len(r[case]["losses"]) == len(ref["losses"])
        for ours, theirs in zip(r[case]["losses"], ref["losses"]):
            _assert_losses(ours, theirs, rtol=1e-6)
        for key in ("grads", "stats", "params"):
            if key in ref:
                _assert_rel(r[case][key], ref[key], 1e-9, atol=1e-10)


def test_losses_equal_jax(run):
    """(c) step 1's losses equal JAX's single-process forward on the same
    global batch, weights and automask noise."""
    for r in run["ranks"]:
        _assert_losses(r["kitti"]["losses"][0], run["refs"]["jax"])


def test_batch_norm_takes_global_statistics(run):
    """models/resnet.BatchNorm2d over two ranks equals one BN on the
    concatenated batch: outputs, input gradients, running statistics;
    the ranks' weight gradients sum to the one-process gradient."""
    ref = run["refs"]["bn"]
    for r, out in enumerate(run["ranks"]):
        bn = out["bn"]
        for key in ("y", "x_grad"):
            np.testing.assert_allclose(bn[key], _rows(ref[key], r),
                                       atol=1e-6, err_msg=key)
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(bn[key], ref[key], atol=1e-6,
                                       err_msg=key)
    np.testing.assert_allclose(sum(o["bn"]["weight_grad"]
                                   for o in run["ranks"]),
                               ref["weight_grad"], atol=1e-5)


def test_ratio_terms_are_global(run):
    """Rank 0's rows carry hints almost everywhere, rank 1's at 1 pixel
    in 64: the ratio terms (sum(x * mask) / sum(mask)) are the global
    batch's, so the ranks equal one process, while the average of the
    halves' own losses lies far away."""
    _assert_float64_equal(run, "ratio")
    ref = run["refs"]["ratio"]["losses"][0]
    halves = run["refs"]["ratio_halves"]
    for key in ("loss", "depth_hint_loss/0", "reproj_loss/0"):
        averaged = np.mean([h[key] for h in halves])
        gap = abs(averaged - ref[key])
        assert gap > 1e-3 * abs(ref[key]), (key, gap)


def test_bf16_step_equals_one_process(run):
    """The mixed-precision steps (bfloat16 networks over float32
    masters), KITTI and NYU, on two ranks as on one process."""
    for case in ("bf16", "nyu_bf16"):
        ref = run["refs"][case]
        for r in run["ranks"]:
            _assert_losses(r[case]["losses"][0], ref["losses"][0],
                           rtol=1e-3)


def test_nyu_two_ranks_equal_one_process(run):
    _assert_float64_equal(run, "nyu")


def test_nyu_losses_are_global_means(run):
    """losses_nyu's SSIM (and its cs), BerHu (its threshold the global
    batch's largest error, held by rank 1) and cropped L1, and their
    gradient, on two ranks as on one process."""
    ref = run["refs"]["nyu_losses"]
    for r, out in enumerate(run["ranks"]):
        got = out["nyu_losses"]
        np.testing.assert_allclose(got["values"], ref["values"], rtol=1e-5)
        np.testing.assert_allclose(got["grad"] / WORLD,
                                   _rows(ref["grad"], r), rtol=1e-4,
                                   atol=1e-8)


def test_helpers_equal_jax(run, monkeypatch):
    """process_shard interleaves as JAX's; multihost_setup refuses what
    JAX's refuses with JAX's messages; agree_across_processes passes an
    agreed value and raises when the ranks disagree."""
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    monkeypatch.setattr(jax, "device_count", lambda: WORLD)
    items = [f"item{i:02d}" for i in range(11)]
    for r, out in enumerate(run["ranks"]):
        h = out["helpers"]
        monkeypatch.setattr(jax, "process_index", lambda: r)
        assert out["world"] == WORLD
        assert h["shard"] == jmesh.process_shard(items)
        expected = []
        for batch, axis in ((7, 1), (8, 3)):
            with pytest.raises(SystemExit) as e:
                jmesh.multihost_setup(batch, axis)
            expected.append(str(e.value))
        assert h["refused"] == expected
        assert tuple(h["setup"]) == jmesh.multihost_setup(8, 1) == (4, 2)
        assert h["agree"] == 7
        assert h["disagree"].startswith(
            "auto-resume epoch disagrees across processes: [0, 1]")


def test_multihost_setup_single_process_equals_jax():
    """One process: JAX's pass-through and its data-mesh refusal, with
    its message; the launcher's check with JAX's host and device counts;
    the port's own refusals of half-given multi-host flags."""
    assert mesh.multihost_setup(12, 2) == jmesh.multihost_setup(12, 2)
    with pytest.raises(SystemExit) as ours:
        mesh.multihost_setup(7, 2)
    with pytest.raises(SystemExit) as theirs:
        jmesh.multihost_setup(7, 2)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit, match="must span all 8 global devices"):
        mesh.multihost_setup(8, 4, nproc=2, ndev=8)
    assert mesh.agree_across_processes(7, "probe") == 7
    assert mesh.world_size() == 1 and mesh.process_shard([1, 2]) == [1, 2]
    with pytest.raises(SystemExit, match="go together"):
        mesh.initialize_distributed("127.0.0.1:1", None, 0)
    with pytest.raises(SystemExit, match=r"lie in \[0, 2\)"):
        mesh.initialize_distributed("127.0.0.1:1", 2, 2)
    assert mesh.initialize_distributed() is False


def test_multihost_flags_train_both_clis(run):
    """tools/train_kitti.main and tools/train_nyu.main with the multi-host
    flags: the ranks log the same global losses, rank 0 writes each
    checkpoint once, and --auto_resume continues on every rank at the
    epoch after it."""
    c0, c1 = (r["cli"] for r in run["ranks"])
    for key in ("kitti", "kitti_resumed", "nyu"):
        assert c0[key]["losses"] == c1[key]["losses"]
        assert c0[key]["val_losses"] == c1[key]["val_losses"]
        assert c0[key]["checkpoints"] == c1[key]["checkpoints"]
        assert np.isfinite([v for d in c0[key]["losses"]
                            for v in d.values()]).all()
    assert c0["kitti"]["steps"] == 2 and c0["nyu"]["steps"] == 2
    assert c0["kitti_resumed"]["steps"] == 2
    assert c0["kitti_resumed"]["checkpoints"][0].endswith("weights_1")
    models = run["tmp"] / "klog" / "mh" / "models"
    assert sorted(os.listdir(models)) == ["opt.json", "weights_0",
                                          "weights_1"]
    assert sorted(os.listdir(models / "weights_0")) == [
        "adam.pth", "depth.pth", "encoder.pth"]


KITTI_ARGV = ["--split", "tiny", "--height", "64", "--width", "96",
              "--use_stereo", "--frame_ids", "0", "--use_depth_hints",
              "--use_wavelets", "--batch_size", "4", "--weights_init",
              "scratch", "--num_epochs", "1", "--num_workers", "1",
              "--log_frequency", "1", "--device", "cpu"]


def test_data_axis_starts_ranks(run, tmp_path, monkeypatch):
    """--data_axis 2 on one host starts two ranks (gloo on the CPU):
    train_kitti and train_nyu return rank 0's summary and write one
    checkpoint; a rank that fails makes the command exit non-zero."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tmp = run["tmp"]
    k = train_kitti.main(["--data_path", str(tmp / "kitti"), "--log_dir",
                          str(tmp_path), "--model_name", "k",
                          "--data_axis", "2"] + KITTI_ARGV)
    assert k["steps"] == 2 and len(k["losses"]) == 2
    assert k["checkpoints"] == [str(tmp_path / "k" / "models" / "weights_0")]
    n = train_nyu.main(["--data_path", str(tmp / "nyu_data.zip"),
                        "--encoder_type", "mobilenet_light",
                        "--use_wavelets", "--use_224", "--batch_size", "2",
                        "--epochs", "1", "--num_workers", "1",
                        "--no-pretrained_encoder", "--log_dir",
                        str(tmp_path), "--model_name", "n", "--device",
                        "cpu", "--data_axis", "2"])
    assert n["steps"] == 2 and n["checkpoints"] == [
        str(tmp_path / "n" / "models" / "weights_0")]
    with pytest.raises(SystemExit, match="exited with code"):
        train_kitti.main(["--data_path", str(tmp_path / "absent"),
                          "--log_dir", str(tmp_path), "--data_axis", "2"]
                         + KITTI_ARGV)
