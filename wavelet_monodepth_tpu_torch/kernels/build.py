"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface. `load(name)` compiles
it with nvcc for Hopper (`sm_90a`) into a shared library under the
package's git-ignored `_build/` directory, named by a hash of the source
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
    if name in _libs:
        return _libs[name]
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    info = {"seconds": 0.0, "ptxas": "", "path": str(lib_path)}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic against concurrent builders
        info["seconds"] = time.perf_counter() - t0
        info["ptxas"] = proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    build_info[name] = info
    _libs[name] = lib
    return lib
