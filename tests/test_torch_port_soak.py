"""The port's KITTI training soak (tools/soak_kitti.py) against the JAX
package's harness (tools_dev/soak_kitti_experiment.py): the analysis of
a recorded console log and memory trace (the JAX harness's keys and
checks, as its round-5 result file records them), and one real run on
the CPU with a kill after an epoch and an --auto_resume relaunch.
"""

import json
import os

import pytest

from test_torch_port_data import write_mount
from wavelet_monodepth_tpu_torch.tools import soak_kitti
from wavelet_monodepth_tpu_torch.utils.logging import TrainTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_result():
    with open(os.path.join(REPO, "artifacts", "soak_kitti_r5.json")) as f:
        return json.load(f)


def _console(losses_by_epoch, resume_at):
    """A trainer console log in the training CLI's format: one line per
    loss, the resume line before epoch `resume_at`."""
    timer = TrainTimer(100)
    lines, step = [], 0
    for epoch, losses in enumerate(losses_by_epoch):
        if epoch == resume_at:
            lines.append("auto-resume: restoring /x/models/weights_"
                         f"{epoch - 1}, continuing at epoch {epoch}")
        for i, loss in enumerate(losses):
            step += 1
            lines.append(timer.log_line(epoch, i, step, 12,
                                        {"batch_process": 0.1,
                                         "dataloading": 0.01}, loss))
    return "\n".join(lines) + "\n"


def _analyse(log, rss_a, rss_b, **kw):
    kw = dict(dict(num_epochs=6, kill_after_epoch=3, steps_per_epoch=20,
                   rc=0, final_checkpoint=True, wall_s=100.0,
                   phase_b_wall_s=40.0, tb_event_files=[], config="test"),
              **kw)
    return soak_kitti.analyse(log, rss_a, rss_b, **kw)


def test_analysis_keys_and_checks():
    losses = [[3.0, 2.8], [2.5, 2.4], [2.2, float("inf")], [2.0, 1.9],
              [1.8, 1.7], [1.6, 1.5]]
    rss_a = [(float(t), 1000 + t, 800 + t) for t in range(6)]
    flat = [(10.0 + t, 1200, 900) for t in range(8)]
    s = _analyse(_console(losses, 4), rss_a, flat)
    ref = _jax_result()
    assert set(ref) <= set(s)
    assert set(s["checks"]) == set(ref["checks"])
    assert s["checks"] == {
        "completed": True, "resumed_from_killed_epoch": True,
        "phase_b_logged": True, "all_losses_finite": False,
        "loss_trending_down": True, "final_checkpoint_exists": True,
        "anon_rss_stable": True}
    assert not s["ok"]
    assert s["n_logged_lines"] == [8, 4] and s["resumed_at_epoch"] == 4
    assert s["phase_b_steps"] == 40 and s["phase_b_ms_per_step"] == 1000.0
    assert s["rss_mb_max"] == 1200 and s["anon_mb_last"] == 900
    assert s["anon_mb_per_min_after_warmup"]["b"] == 0.0
    assert s["anon_mb_per_min_after_warmup"]["a"] == pytest.approx(60.0)
    assert s["epoch_mean_loss"][0] == pytest.approx(2.9)

    # anonymous memory that keeps growing after the resume, a resume from
    # the wrong epoch, a failed relaunch, losses that do not fall
    growing = [(10.0 + t, 1200 + 100 * t, 900 + 100 * t) for t in range(8)]
    s = _analyse(_console([[2.0, 2.0]] * 6, 3), rss_a, growing, rc=1,
                 final_checkpoint=False)
    assert not any(s["checks"][k] for k in (
        "completed", "resumed_from_killed_epoch", "loss_trending_down",
        "final_checkpoint_exists", "anon_rss_stable"))
    assert s["anon_mb_per_min_after_warmup"]["b"] == pytest.approx(6000.0)
    # too few samples to judge
    s = _analyse(_console(losses[:5], 4), rss_a, growing[:3])
    assert s["checks"]["anon_rss_stable"] is False


def test_soak_kills_resumes_and_reports(tmp_path, monkeypatch):
    # the trainer subprocess on one thread: with every core's worth of
    # threads it competes with the suite's other workers and ran 6x slower
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = str(tmp_path / "kitti")
    write_mount(root, 4, 75, 124)
    out = str(tmp_path / "soak.json")
    s = soak_kitti.main([
        "--data_path", root, "--split", "tiny", "--out", out,
        "--num_epochs", "3", "--kill_after_epoch", "0", "--interval", "0.2",
        "--poll", "0.05", "--kill_delay", "0", "--height", "64", "--width",
        "96", "--batch_size", "2", "--log_frequency", "2", "--num_workers",
        "1", "--no-bfloat16", "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(s))
    for check in ("completed", "resumed_from_killed_epoch", "phase_b_logged",
                  "all_losses_finite", "final_checkpoint_exists"):
        assert s["checks"][check], (check, s)
    assert s["resumed_at_epoch"] == 1 and s["steps_per_epoch"] == 2
    assert s["n_logged_lines"][1] == 2
    assert s["rss_mb_max"] > 0 and s["anon_mb_max"] > 0
    assert set(os.listdir(tmp_path)) == {"kitti", "soak.json", "soak_logs"}
    assert sorted(os.listdir(tmp_path / "soak_logs" / "soak" / "models")) \
        == ["opt.json", "weights_0", "weights_1", "weights_2"]


def test_soak_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        soak_kitti.main(["--data_path", str(tmp_path), "--out",
                         str(tmp_path / "x.json")])
    assert not os.path.exists(tmp_path / "soak_logs")


def test_memory_falls_back_to_proc_status(monkeypatch):
    """Where /proc/<pid>/smaps_rollup is missing, the samples come from
    /proc/<pid>/status's VmRSS and RssAnon, else from /proc/<pid>/statm,
    which here agree with it within 20%."""
    pid = os.getpid()
    assert soak_kitti.memory_source(pid) == "smaps_rollup"
    rss, anon = soak_kitti.read_memory(pid)
    rss_s, anon_s = soak_kitti.read_memory(pid, "status")
    assert rss > 0 and anon > 0
    assert abs(rss_s - rss) <= 0.2 * rss and abs(anon_s - anon) <= 0.2 * anon
    rss_m, anon_m = soak_kitti.read_memory(pid, "statm")
    assert abs(rss_m - rss) <= 0.2 * rss and abs(anon_m - anon) <= 0.2 * anon
    monkeypatch.setattr(soak_kitti, "MEMORY_SOURCES", (
        ("no_such_file", "Rss:", "Anonymous:"),) + soak_kitti.MEMORY_SOURCES)
    assert soak_kitti.memory_source(pid) == "smaps_rollup"
    monkeypatch.setattr(soak_kitti, "MEMORY_SOURCES", (
        ("no_such_file", "Rss:", "Anonymous:"),
        ("status", "VmRSS:", "RssAnon:")))
    assert soak_kitti.memory_source(pid) == "status"
    monkeypatch.setattr(soak_kitti, "MEMORY_SOURCES", (
        ("no_such_file", "Rss:", "Anonymous:"), ("statm", None, None)))
    assert soak_kitti.memory_source(pid) == "statm"
    monkeypatch.setattr(soak_kitti, "MEMORY_SOURCES", (
        ("no_such_file", "Rss:", "Anonymous:"),))
    with pytest.raises(RuntimeError, match="no memory source"):
        soak_kitti.memory_source(pid)
