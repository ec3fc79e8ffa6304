"""ctypes binding of the repo's native host runtime (`native/wmd_native.cpp`).

Counterpart of `wavelet_monodepth_tpu/data/native_loader.py`, with its six
functions and signatures, all on numpy arrays on the host: the threaded
OpenCV decode + Lanczos resize of a batch of image files (float32 in
[0, 1], or uint8), the half-scale Lanczos pyramid, the velodyne-to-depth
projection and a single-level Haar transform and its inverse.

The port builds the library itself at first use, with `g++` and the
flags of `native/build.sh`, from `native/wmd_native.cpp`, which it only
reads, into the package's git-ignored `_build/` directory. The file is
named by a hash of the source, the flags and the host's CPU model
(`-march=native` builds for that CPU), as `kernels/build.py` names the
CUDA kernels. It never writes into `native/`. When the library cannot be
built, `load_library` raises `NativeUnavailable`, which names what is
missing (`g++`, OpenCV's headers under /usr/include/opencv4, or the
libopencv_imgcodecs / imgproc / core libraries); nothing here falls back
to PIL.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "wmd_native.cpp"
BUILD_DIR = _PKG / "_build"
OPENCV_INCLUDE = Path("/usr/include/opencv4")
OPENCV_LIBS = ("opencv_imgcodecs", "opencv_imgproc", "opencv_core")
# native/build.sh's command, minus its output path
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             f"-I{OPENCV_INCLUDE}")
LINK_FLAGS = tuple(f"-l{lib}" for lib in OPENCV_LIBS) + ("-lpthread",)

_lib = None


class NativeUnavailable(RuntimeError):
    """The native library cannot be built or loaded on this host;
    `missing` lists what was absent."""

    def __init__(self, missing: list, detail: str = ""):
        self.missing = list(missing)
        super().__init__(
            "the native decoder (native/wmd_native.cpp) cannot be built: "
            f"missing {', '.join(self.missing)}"
            + (f"\n{detail}" if detail else "")
            + "\nit needs g++, OpenCV's headers in /usr/include/opencv4 and "
              "the libopencv_imgcodecs, libopencv_imgproc and libopencv_core "
              "libraries; the PIL feed runs without --native_decode")


def missing_requirements() -> list:
    """What the build needs and this host lacks (empty when all is there)."""
    missing = []
    if shutil.which("g++") is None:
        missing.append("g++")
    if not (OPENCV_INCLUDE / "opencv2" / "imgcodecs.hpp").is_file():
        missing.append(str(OPENCV_INCLUDE))
    missing += [f"lib{lib}" for lib in OPENCV_LIBS
                if ctypes.util.find_library(lib) is None]
    if not SOURCE.is_file():
        missing.append(str(SOURCE))
    return missing


def _host_cpu() -> str:
    """The host's CPU model: -march=native builds for it."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    """Where the library of this source, these flags and this host's CPU
    is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LINK_FLAGS).encode()
                            + _host_cpu().encode())
    return BUILD_DIR / f"libwmd_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it is there; returns its path."""
    missing = missing_requirements()
    if missing:
        raise NativeUnavailable(missing)
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), *LINK_FLAGS,
                           "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(["a successful g++ build"], proc.stderr)
    os.replace(tmp, path)           # atomic against concurrent builders
    return path


def load_library(path: Optional[str] = None):
    """The loaded library (built at first use); cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(path or build()))
    ptr = ctypes.POINTER
    c_int = ctypes.c_int
    for name, out in (("wmd_decode_resize_batch", ctypes.c_float),
                      ("wmd_decode_resize_batch_u8", ctypes.c_ubyte)):
        fn = getattr(lib, name)
        fn.restype = c_int
        fn.argtypes = [ptr(ctypes.c_char_p), c_int, c_int, c_int, ptr(c_int),
                       ptr(out), c_int]
    lib.wmd_velodyne_to_depth.restype = None
    lib.wmd_velodyne_to_depth.argtypes = [
        ptr(ctypes.c_float), c_int, ptr(ctypes.c_double), c_int, c_int,
        ptr(ctypes.c_float)]
    lib.wmd_build_pyramid.restype = None
    lib.wmd_haar_dwt2.restype = None
    lib.wmd_haar_idwt2.restype = None
    _lib = lib
    return lib


def available() -> bool:
    try:
        load_library()
        return True
    except (NativeUnavailable, OSError):
        return False


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _decode(fn_name: str, dtype, paths: Sequence[str], height: int,
            width: int, flips: Optional[Sequence[bool]], num_threads: int):
    fn = getattr(load_library(), fn_name)
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    flip = np.asarray([1 if (flips is not None and flips[i]) else 0
                       for i in range(n)], np.int32)
    rc = fn(c_paths, n, height, width,
            flip.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out.ctypes.data_as(fn.argtypes[5]), num_threads)
    if rc != 0:
        raise IOError(f"failed to load image: {paths[rc - 1]}")
    return out


def decode_resize_batch(paths: Sequence[str], height: int, width: int,
                        flips: Optional[Sequence[bool]] = None,
                        num_threads: int = 4) -> np.ndarray:
    """Decode + Lanczos-resize a batch of images to float32 NHWC [0, 1]."""
    return _decode("wmd_decode_resize_batch", np.float32, paths, height,
                   width, flips, num_threads)


def decode_resize_batch_u8(paths: Sequence[str], height: int, width: int,
                           flips: Optional[Sequence[bool]] = None,
                           num_threads: int = 4) -> np.ndarray:
    """The same, as uint8 NHWC [0, 255]: the float variant is this * 1/255
    exactly, and the forward casts on the card."""
    return _decode("wmd_decode_resize_batch_u8", np.uint8, paths, height,
                   width, flips, num_threads)


def build_pyramid(img: np.ndarray, levels: int) -> list:
    """Chained half-scale Lanczos pyramid of a float32 (H, W, 3) image."""
    lib = load_library()
    h, w = img.shape[:2]
    img = np.ascontiguousarray(img, np.float32)
    outs = []
    ptrs = (ctypes.POINTER(ctypes.c_float) * levels)()
    for level in range(levels):
        h, w = h // 2, w // 2
        outs.append(np.empty((h, w, 3), np.float32))
        ptrs[level] = _fptr(outs[-1])
    lib.wmd_build_pyramid(_fptr(img), img.shape[0], img.shape[1], levels,
                          ptrs)
    return outs


def velodyne_to_depth(points: np.ndarray, P_velo2im: np.ndarray,
                      im_shape: tuple) -> np.ndarray:
    """points (N, 4) float32, P (3, 4) -> depth (H, W) float32."""
    lib = load_library()
    pts = np.ascontiguousarray(points, np.float32)
    P = np.ascontiguousarray(P_velo2im, np.float64)
    h, w = im_shape
    depth = np.empty((h, w), np.float32)
    lib.wmd_velodyne_to_depth(
        _fptr(pts), len(pts),
        P.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), h, w,
        _fptr(depth))
    return depth


def haar_dwt2(x: np.ndarray):
    """(ll, lh, hl, hh) of a float32 (H, W) array, H and W even."""
    lib = load_library()
    h, w = x.shape
    x = np.ascontiguousarray(x, np.float32)
    bands = [np.empty((h // 2, w // 2), np.float32) for _ in range(4)]
    lib.wmd_haar_dwt2(_fptr(x), h, w, *[_fptr(b) for b in bands])
    return tuple(bands)


def haar_idwt2(ll, lh, hl, hh) -> np.ndarray:
    lib = load_library()
    oh, ow = ll.shape
    out = np.empty((oh * 2, ow * 2), np.float32)
    args = [np.ascontiguousarray(a, np.float32) for a in (ll, lh, hl, hh)]
    lib.wmd_haar_idwt2(*[_fptr(a) for a in args], oh, ow, _fptr(out))
    return out
