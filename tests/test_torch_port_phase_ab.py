"""tools/phase_ab.py's arguments, the program it runs in a tree for a
named phase (no tree is launched here: a run needs a card) and its table
of a whole chip_smoke run's phase seconds."""

import ast
import inspect
import json
import os
import sys

import pytest

from wavelet_monodepth_tpu_torch.tools import phase_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_arguments():
    args = phase_ab.parse_args(["a", "b", "b", "a"])
    assert args.trees == ["a", "b", "b", "a"] and args.phases == ["ddp"]
    args = phase_ab.parse_args(["--phase", "nyu", "--timeout", "60", "x"])
    assert (args.phases, args.timeout, args.trees) == (["nyu"], 60.0, ["x"])
    args = phase_ab.parse_args(["--phase", "nyu", "--phase", "nyu_train",
                                "a", "b"])
    assert args.phases == ["nyu", "nyu_train"]
    assert phase_ab.parse_args(["--list"]).list
    assert phase_ab.parse_args(["--table", "a", "b"]).table == ["a", "b"]
    for bad in (["--phase", "no_such_phase", "x"], [], ["--phase", "nyu"]):
        with pytest.raises(SystemExit):
            phase_ab.parse_args(bad)


def test_list_names_every_phase(capsys):
    assert phase_ab.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out] == sorted(phase_ab.PHASES)
    assert "soak_nyu: needs nyu_zip" in out


@pytest.mark.parametrize("phase", sorted(phase_ab.PHASES))
def test_script_calls_chip_smoke_s_phase(phase):
    """The program compiles, sets up what the phase needs before the
    clock starts, and every chip_smoke function it calls exists and takes
    the arguments it is given; the phase's call is the one timed."""
    src = phase_ab.script([phase])
    tree = ast.parse(src)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and isinstance(n.func.value, ast.Name)
             and n.func.value.id == "cs"]
    assert calls
    for node in calls:
        fn = getattr(chip_smoke, node.func.attr)
        inspect.signature(fn).bind(*node.args)
    _, call = phase_ab.PHASES[phase]
    t0 = src.index("t0 = time.perf_counter()")
    assert src.index(call) > t0 > src.index("cs.trace_calls(") > \
        src.index("cs.phase_build()") > src.index("cs.start_data(tmp)")
    assert src.index("seconds = time.perf_counter() - t0") > src.index(call)
    assert f'"phase_name": {phase!r}' in src
    for need in phase_ab.PHASES[phase][0]:
        assert src.index(phase_ab.SETUP[need][0]) < t0


def test_script_times_each_phase_in_turn():
    """Several phases: what any of them needs is set up once before the
    first clock starts, then each phase's call is timed on its own, in
    the order given."""
    phases = ["nyu", "nyu_train", "kitti_hr_train"]
    src = phase_ab.script(phases)
    ast.parse(src)
    first = src.index("t0 = time.perf_counter()")
    assert src.index(phase_ab.SETUP["kitti"][1]) < first
    at = 0
    for phase in phases:
        t0 = src.index("t0 = time.perf_counter()", at)
        call = src.index(phase_ab.PHASES[phase][1], t0)
        end = src.index("seconds = time.perf_counter() - t0", call)
        assert src.index(f'"phase_name": {phase!r}', end) > end
        at = end
    assert src.count("t0 = time.perf_counter()") == len(phases)


def test_table_of_a_run(tmp_path, capsys):
    """--table splits a run's stdout at each phase's first line: a phase
    ends at its last line, lines without "t" (the card's nvidia-smi line,
    the kernels line) and phases the run lacks are skipped, and a line
    name that recurs later (kernel_vs_plain in phase 12) stays with the
    phase it is in."""
    lines = ["NVIDIA H100 80GB HBM3, 700.00 W",
             {"phase": "device", "t": 10.0}, {"phase": "build", "t": 14.0},
             {"phase": "build", "t": 20.0},
             {"phase": "kernel_vs_plain", "t": 25.0},
             {"phase": "eval_mount", "t": 30.0},
             {"phase": "nyu_mount", "t": 40.0},
             {"phase": "kernel_vs_plain", "t": 45.0},
             {"phase": "soak_nyu", "t": 60.0},
             {"kernels": []}, {"ok": True}]
    out = tmp_path / "run.jsonl"
    out.write_text("\n".join(ln if isinstance(ln, str) else json.dumps(ln)
                             for ln in lines) + "\n")
    assert phase_ab.main(["--table", str(out)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == {"run": str(out), "last_t": 60.0, "phases": {
        "1 device": 10.0, "2 build": 10.0, "3 kernel vs plain": 5.0,
        "11 eval": 5.0, "12 nyu": 15.0, "17c soak_nyu": 15.0}}
    assert [name for name, _ in phase_ab.SECTIONS][-1] == \
        "21-22 ddp + spatial"
