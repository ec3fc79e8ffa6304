"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface. `load(name)` compiles
it with nvcc for Hopper (`sm_90a`) into a shared library under the
package's git-ignored `_build/` directory (`load_all(names)` builds
several, one nvcc each, all started together), named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused. The JAX package has no counterpart: Pallas kernels compile inside
`jax.jit`.

Pointers and the stream cross ctypes as `c_void_p` (a bare Python int
would be cut to 32 bits); each C entry returns `cudaGetLastError()` after
its launch and the Python wrapper raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": build time (0.0 when reused), "ptxas": nvcc's
# register/shared-memory report, "path": the library}
build_info: dict[str, dict] = {}
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if absent."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH): the port's CUDA kernels are built from "
            f"{SRC_DIR} at first use and need the CUDA toolkit")
    return found


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    return load_all([name])[0]


def load_all(names) -> list:
    """Build (if needed) and load several sources: one nvcc per source,
    all started together, so the build takes as long as the slowest."""
    return finish_all(start_all(names))


def start_all(names) -> tuple:
    """Start one nvcc per source not yet loaded, all together, and return
    at once: (names, their running builds), which finish_all waits for
    (the caller may do other work in between)."""
    names, jobs = list(names), {}
    try:
        for name in names:
            if name not in _libs and name not in jobs:
                jobs[name] = _start(name)
    except BaseException:
        stop_all(jobs)
        raise
    return names, jobs


def finish_all(started: tuple) -> list:
    """Wait for start_all's builds and load every library it names."""
    names, jobs = started
    try:
        for name, job in jobs.items():
            _finish(name, *job)
    finally:                        # a failed build stops the others
        stop_all(jobs)
    return [_libs[name] for name in names]


def stop_all(jobs: dict) -> None:
    """Kill the builds' nvcc processes that are still running."""
    for job in jobs.values():
        if job[3] is not None and job[3].poll() is None:
            job[3].kill()
            job[3].wait()


def _start(name: str):
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if lib_path.exists():
        return src, lib_path, None, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return src, lib_path, tmp, proc, time.perf_counter()


def _finish(name: str, src, lib_path, tmp, proc, t0) -> None:
    info = {"seconds": 0.0, "ptxas": "", "path": str(lib_path)}
    if proc is not None:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {proc.returncode}):\n{stderr}")
        os.replace(tmp, lib_path)   # atomic against concurrent builders
        info["seconds"] = time.perf_counter() - t0
        info["ptxas"] = stderr
    build_info[name] = info
    _libs[name] = ctypes.CDLL(str(lib_path))
