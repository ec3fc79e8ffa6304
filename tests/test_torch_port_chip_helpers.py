"""chip_smoke.py's host-side helpers that need no card: the trace reader
(`Trace`, read from torch.profiler's kineto results) against
prof.events() on a CPU profile, the run's first-trace check as a
`require`, and the ddp phase's wait for the ranks' records and its
overlap of the --data_axis launcher with the ranks' timings, and the
sleep ahead of a queued timing window."""

import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _cpu_profile(shapes: bool):
    from torch.profiler import ProfilerActivity, profile
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(2, 3, 8, 8)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=shapes) as prof:
        for _ in range(2):
            conv(x).relu().sum()
    return prof


@pytest.mark.parametrize("shapes", [False, True])
def test_trace_reader_equals_prof_events(shapes):
    """Every host op with its thread, times, shapes, kernels, parent and
    children as prof.events() has them (no device events on the CPU)."""
    prof = _cpu_profile(shapes)
    check = chip_smoke.check_trace(chip_smoke.Trace(prof), prof)
    assert check["ok"], check
    assert check["host_ops"] > 0 and check["device_events"] == 0


def test_read_trace_requires_its_first_check(monkeypatch, capsys):
    """The run's first trace is checked and must pass (no other reader
    takes over); later traces are read without the check."""
    prof = _cpu_profile(False)
    monkeypatch.setattr(chip_smoke, "_trace_checked", [])
    monkeypatch.setattr(chip_smoke, "check_trace",
                        lambda trace, prof: {"ok": False})
    with pytest.raises(RuntimeError, match="trace reader differs"):
        chip_smoke.read_trace(prof, False)
    assert '"trace_reader_check"' in capsys.readouterr().out
    monkeypatch.setattr(chip_smoke, "_trace_checked", [])
    calls = []
    monkeypatch.setattr(chip_smoke, "check_trace", lambda trace, prof: (
        calls.append(1) or {"ok": True}))
    for _ in range(2):
        assert isinstance(chip_smoke.read_trace(prof, False),
                          chip_smoke.Trace)
    assert calls == [1]


def test_wait_for_files(tmp_path):
    """It returns as soon as the files exist, at once when a process has
    exited before them (no wait for the timeout), and False after the
    timeout."""
    paths = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    sleeper = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(30)"])
    try:
        t0 = time.time()
        assert not chip_smoke.wait_for_files(paths, [sleeper], 0.2)
        for p in paths:
            open(p, "w").close()
        assert chip_smoke.wait_for_files(paths, [sleeper], 30)
        assert time.time() - t0 < 10
    finally:
        sleeper.kill()
        sleeper.wait()
    os.remove(paths[1])
    dead = subprocess.Popen([sys.executable, "-c", "raise SystemExit(1)"])
    dead.wait()
    t0 = time.time()
    assert not chip_smoke.wait_for_files(paths, [dead], 300)
    assert time.time() - t0 < 5


@pytest.mark.parametrize("window, want", [
    ((0.0, 5.0), [0.0, 0.0]),         # before both ranks' marks
    ((12.0, 30.0), [8.0, 3.0]),       # over the marks' ends
    ((11.0, 13.0), [2.0, 2.0]),       # inside both
])
def test_launcher_overlap_s(window, want):
    recs = [{"clock": {"ready": 10.0, "done": 20.0}},
            {"clock": {"ready": 10.5, "done": 15.0}}]
    got = chip_smoke.launcher_overlap_s(window, recs, "ready", "done")
    assert got == pytest.approx(want)


@pytest.mark.parametrize("window_host_ms, cycles_per_ms, want", [
    (0.5, 1.98e6, chip_smoke.QUEUE_AHEAD_CYCLES),   # kernels: the floor
    (42.5, 1.98e6, int(1.5 * 42.5 * 1.98e6)),       # a host-paced forward
    (100.0, 1.0e6, int(1.5e8)),
])
def test_queue_ahead_cycles(window_host_ms, cycles_per_ms, want):
    """The sleep ahead of a queued window covers 1.5x the window's host
    time, and never falls below the ~10 ms floor."""
    got = chip_smoke.queue_ahead_cycles(window_host_ms, cycles_per_ms)
    assert got == want
    assert got >= chip_smoke.QUEUE_AHEAD_CYCLES
    assert got >= window_host_ms * cycles_per_ms
