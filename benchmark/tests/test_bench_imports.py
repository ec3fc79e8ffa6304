"""The import boundary: nothing under benchmark/ imports JAX or the JAX
package, and the yardstick (reference/, gen/, work/) imports nothing of
the port either. Top-level names are compared whole: the port's name
begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
NEVER = {"jax", "jaxlib", "flax", "wavelet_monodepth_tpu"}
PORT = "wavelet_monodepth_tpu_torch"
YARDSTICK = ("reference", "gen", "work", "metrics", "trace.py",
             "weights.py")


def _imports(path: Path) -> list:
    """(top-level name, level, dotted module) of every import in a file,
    inside functions too."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            out.append((mod.split(".")[0], node.level, mod))
    return out


def _resolve(path: Path, level: int, mod: str) -> str:
    """The package under benchmark/ that a relative import reaches."""
    parts = list(path.relative_to(BENCH.parent).with_suffix("").parts)
    base = parts[:len(parts) - level]
    return ".".join(base + ([mod] if mod else []))


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH.parent)))
def test_no_jax(path):
    bad = [m for top, level, m in _imports(path)
           if level == 0 and top in NEVER]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [p for p in FILES if p.relative_to(
    BENCH).parts[0] in YARDSTICK], ids=lambda p: str(p.relative_to(
        BENCH.parent)))
def test_yardstick_has_no_port(path):
    for top, level, mod in _imports(path):
        assert not (level == 0 and top == PORT), f"{path} imports {mod}"
        if level:
            target = _resolve(path, level, mod).split(".")
            assert target[0] == "benchmark" and (
                len(target) == 1 or target[1] in YARDSTICK
                or f"{target[1]}.py" in YARDSTICK), (
                f"{path} imports {'.' * level}{mod}, outside the "
                "yardstick")


def test_yardstick_loads_no_port_in_a_process():
    mods = [".".join(p.relative_to(BENCH.parent).with_suffix("").parts)
            for p in FILES if p.relative_to(BENCH).parts[0] in YARDSTICK
            and p.name != "__init__.py" and p.stem.count(".") == 0]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(NEVER | {PORT})!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
