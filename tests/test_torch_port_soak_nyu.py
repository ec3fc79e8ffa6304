"""The port's NYU training soak (tools/soak_nyu.py) against the JAX
package's harness (tools_dev/soak_nyu_experiment.py): the harness's own
main() on a recorded console log and memory trace, with the trainer and
the memory monitor replaced, held key for key to the port's analysis of
the same log and samples; the harness's round-5 result file under the
trend factor it was run with and the one it has now; one real run on the
CPU; and the device rule.
"""

import importlib.util
import json
import os
import subprocess
import threading
import zipfile

import pytest

from wavelet_monodepth_tpu_torch.tools import soak_nyu
from torch_tmp import drop_module_tmp  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 4


def _harness():
    """tools_dev/soak_nyu_experiment.py as a fresh module, unedited."""
    spec = importlib.util.spec_from_file_location(
        "soak_nyu_experiment",
        os.path.join(REPO, "tools_dev", "soak_nyu_experiment.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _console(losses_by_epoch, n_batches=60):
    """A console log in the NYU trainer's format (both packages print the
    reference's line every 5 steps), one line per loss, with a
    checkpoint line after each epoch."""
    lines = []
    for epoch, losses in enumerate(losses_by_epoch):
        for j, loss in enumerate(losses):
            i = 5 * j
            lines.append(f"Epoch: [{epoch}][{i}/{n_batches}]\t"
                         f"Time {0.1 + 0.001 * (epoch + i):.3f}\t "
                         f"Loss {loss:.4f}")
        lines.append(f"saved checkpoint to /x/models/weights_{epoch}")
    return "\n".join(lines) + "\n"


FALLING = [[130.0, 125.0, 122.0], [115.0, 112.0, 110.0],
           [108.0, 106.0, 105.0], [104.0, 103.0, 101.0]]
STABLE = [(1000.0 + 10 * i, 2000 + (40 if i == 2 else 0)) for i in range(8)]
# each case: what it changes from the passing run, and the check it fails
CASES = {
    "pass": ({}, None),
    "trainer_failed": ({"rc": 1}, "completed"),
    "nan_loss": ({"losses": FALLING[:3] + [[104.0, float("nan"), 101.0]]},
                 "all_losses_finite"),
    "inf_loss": ({"losses": FALLING[:3] + [[104.0, float("inf"), 101.0]]},
                 "all_losses_finite"),
    "flat_loss": ({"losses": [[120.0, 118.0, 119.0]] * EPOCHS},
                  "loss_trending_down"),
    # the r5 artifact's pattern: a 10.2% fall passes 0.9, fails 0.8
    "trend_factor_08": ({"losses": [[121.2]] * 1 + [[110.5], [106.5],
                                                    [108.8]],
                         "trend": "0.8"}, "loss_trending_down"),
    "no_checkpoint": ({"checkpoint": False}, "final_checkpoint_exists"),
    "no_event_files": ({"tfevents": False}, "tb_events_exist"),
    "rss_growing": ({"rss": [(1000.0 + 10 * i, 2000 + 400 * i)
                             for i in range(8)]}, "rss_stable"),
    "rss_too_few_samples": ({"rss": STABLE[:3]}, "rss_stable"),
}


class _FakeTrainer:
    """In place of the harness's subprocess.Popen: writes the recorded
    console log to the trainer's stdout and the files a finished run
    leaves, then waits in wait() until the fake monitor has recorded."""

    def __init__(self, log, rc, checkpoint, tfevents, run, epochs,
                 monitored):
        self.log, self.rc, self.monitored = log, rc, monitored
        self.checkpoint, self.tfevents = checkpoint, tfevents
        self.run, self.epochs = run, epochs
        self.pid = os.getpid()

    def __call__(self, cmd, cwd=None, stdout=None, stderr=None, env=None):
        stdout.write(self.log.encode())
        if self.checkpoint:
            os.makedirs(os.path.join(self.run, "models",
                                     f"weights_{self.epochs - 1}"))
        for mode in ("train", "val"):
            os.makedirs(os.path.join(self.run, mode))
            if self.tfevents:
                open(os.path.join(self.run, mode,
                                  "events.out.tfevents.1.x"), "w").close()
        return self

    def wait(self):
        assert self.monitored.wait(30)
        return self.rc


@pytest.mark.parametrize("case", list(CASES))
def test_analysis_equals_the_jax_harness(case, tmp_path, monkeypatch):
    change, fails = CASES[case]
    losses = change.get("losses", FALLING)
    rss = change.get("rss", STABLE)
    rc = change.get("rc", 0)
    log = _console(losses)

    h = _harness()
    log_dir = str(tmp_path / "logs")
    zip_path = tmp_path / "nyu.zip"
    zip_path.write_bytes(b"")                  # present: nothing fabricated
    monkeypatch.setattr(h, "REPO", str(tmp_path))
    monkeypatch.setattr(h, "ZIP", str(zip_path))
    monkeypatch.setattr(h, "LOG_DIR", log_dir)
    monkeypatch.setattr(h, "EPOCHS", EPOCHS)
    if "trend" in change:
        monkeypatch.setattr(h, "TREND_FACTOR", float(change["trend"]))
    monitored = threading.Event()
    run = os.path.join(log_dir, h.MODEL)
    fake = _FakeTrainer(log, rc, change.get("checkpoint", True),
                        change.get("tfevents", True), run, EPOCHS,
                        monitored)
    monkeypatch.setattr(h, "subprocess", type(
        "FakeSubprocess", (), {"Popen": fake, "STDOUT": subprocess.STDOUT}))

    def monitor_rss(pid, out, stop):
        out.extend(rss)
        monitored.set()
    monkeypatch.setattr(h, "monitor_rss", monitor_rss)
    h.main()
    with open(tmp_path / "artifacts" / "soak_nyu_r5.json") as f:
        jax = json.load(f)

    ours = soak_nyu.analyse(
        log, [(t, r, r // 2) for t, r in rss], epochs=EPOCHS,
        steps_per_epoch=h.N_TRAIN // 8, rc=rc,
        final_checkpoint=os.path.isdir(os.path.join(
            run, "models", f"weights_{EPOCHS - 1}")),
        tb_event_files=[f for m in ("train", "val")
                        for f in os.listdir(os.path.join(run, m))],
        wall_s=jax["wall_s"], config=jax["config"],
        trend_factor=h.TREND_FACTOR, arena_max=h.ARENA_MAX)
    ours = json.loads(json.dumps(ours))
    for key, value in jax.items():               # NaN as JSON writes it
        assert json.dumps(ours[key]) == json.dumps(value), key
    assert ours["checks"] == jax["checks"]
    failed = [k for k, v in ours["checks"].items() if not v]
    assert failed == ([fails] if fails else []), failed
    assert ours["ok"] is (fails is None)
    # the key JAX names a step's time is a fifth of the logged step
    if ours["median_step_s_per_line"] is not None:
        assert ours["median_step_s_after_warmup"] == pytest.approx(
            ours["median_step_s_per_line"] / 5)
    assert ours["anon_mb_max"] == max(r for _, r in rss) // 2
    assert ours["n_logged_lines"] == sum(len(v) for v in losses)


@pytest.mark.parametrize("factor, expected", [(0.8, False), (0.9, True)])
def test_r5_epoch_means_under_each_trend_factor(factor, expected):
    """The r5 artifact records loss_trending_down false (it was written
    under a factor of 0.8); its epoch means pass the harness's 0.9."""
    with open(os.path.join(REPO, "artifacts", "soak_nyu_r5.json")) as f:
        r5 = json.load(f)
    assert r5["checks"]["loss_trending_down"] is False
    means = {int(k): v for k, v in r5["epoch_mean_loss"].items()}
    assert soak_nyu.trending_down(means, factor) is expected
    assert _harness().TREND_FACTOR == 0.9


def test_soak_runs_on_the_cpu(tmp_path, monkeypatch):
    # the trainer subprocess on one thread, as the KITTI soak test runs it
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = str(tmp_path / "nyu_data.zip")
    out = str(tmp_path / "soak_nyu.json")
    s = soak_nyu.main([
        "--data_path", data, "--n_train", "4", "--out", out,
        "--epochs", "2", "--batch_size", "2", "--encoder_type",
        "mobilenet_light", "--use_224", "--num_workers", "1",
        "--log_frequency", "2", "--interval", "0.2", "--no-bfloat16",
        "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(s))
    with zipfile.ZipFile(data) as zf:           # fabricated: 4 frames
        assert soak_nyu.zip_rows(data) == 4 and len(zf.namelist()) == 9
    for check in ("completed", "all_losses_finite",
                  "final_checkpoint_exists"):
        assert s["checks"][check], (check, s)
    assert s["checks"]["tb_events_exist"] is s["tensorboardx_available"]
    assert s["total_steps"] == 4 and s["n_logged_lines"] == 2
    assert s["rss_mb_max"] > 0 and s["anon_mb_max"] > 0
    assert s["config"] == "NYU MobileNetV2-light 224x224 b2 f32 wavelets " \
                          "uint8-feed" and s["device"] == "cpu"
    assert set(os.listdir(tmp_path)) == {"nyu_data.zip", "soak_nyu.json",
                                         "soak_nyu_logs"}
    assert sorted(os.listdir(tmp_path / "soak_nyu_logs" / "soak_nyu"
                             / "models")) == ["opt.json", "weights_0",
                                              "weights_1"]


def test_soak_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        soak_nyu.main(["--data_path", str(tmp_path / "nyu.zip"), "--out",
                       str(tmp_path / "x.json")])
    assert os.listdir(tmp_path) == []


def test_trainer_arguments_are_the_harness_s():
    """At its defaults the soak passes the JAX harness's training flags
    (its --data_path, --model_name and --log_dir aside) and names the
    harness's configuration."""
    h = _harness()
    args = soak_nyu.parse_args(["--data_path", "z.zip", "--out", "o.json"])
    ours = soak_nyu.train_argv(args)

    def flags(argv, drop):
        out, i = {}, 0
        while i < len(argv):
            takes = i + 1 < len(argv) and not argv[i + 1].startswith("--")
            if argv[i] not in drop:
                out[argv[i]] = argv[i + 1] if takes else True
            i += 2 if takes else 1
        return out
    drop = {"--data_path", "--model_name", "--log_dir"}
    assert flags(ours, drop | {"--device", "--encoder_type"}) == flags(
        h.ARGS, drop)
    assert flags(ours, set())["--encoder_type"] == "densenet"
    assert soak_nyu.config_of(args) == \
        "NYU DN161 640x480 b8 bf16-mp wavelets uint8-feed"
    assert (args.epochs, args.n_train, args.interval, soak_nyu.TREND_FACTOR,
            soak_nyu.ARENA_MAX) == (h.EPOCHS, h.N_TRAIN, 10.0, h.TREND_FACTOR,
                                    h.ARENA_MAX)
