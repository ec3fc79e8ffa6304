"""KITTI split-file resolution: counterpart of
`wavelet_monodepth_tpu/data/splits.py`, reading the same vendored lists.

The reference ships its train/val/test file lists in-tree
(`KITTI/splits/{eigen,eigen_full,eigen_zhou,eigen_benchmark,odom,benchmark}`,
format "folder frame side" parsed at `KITTI/datasets/mono_dataset.py:179-190`).
We vendor the same lists (dataset metadata, see splits/PROVENANCE.md) under
the repo root so every trainer/evaluator is runnable given only a data root.

Resolution order for a split directory:
  1. $WMD_SPLITS_DIR/<split>
  2. <data_path>/splits/<split> (and its parent dir, for nested data roots)
  3. the vendored <repo>/splits/<split>
"""

from __future__ import annotations

import os

# <package>/data/splits.py -> repo root /splits
VENDORED_SPLITS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "splits"))


def resolve_split_dir(split: str, data_path: str | None = None) -> str:
    """Find the directory holding <split>'s file lists (see module doc)."""
    candidates = []
    env = os.environ.get("WMD_SPLITS_DIR")
    if env:
        candidates.append(os.path.join(env, split))
    if data_path:
        candidates.append(os.path.join(data_path, "splits", split))
        candidates.append(os.path.join(os.path.dirname(data_path),
                                       "splits", split))
    candidates.append(os.path.join(VENDORED_SPLITS_DIR, split))
    for c in candidates:
        if os.path.isdir(c):
            return c
    raise FileNotFoundError(
        f"split '{split}' not found; tried {candidates}")


def readlines(path: str) -> list[str]:
    with open(path, "r") as f:
        return f.read().splitlines()


def read_split(split: str, which: str = "test_files.txt",
               data_path: str | None = None) -> list[str]:
    """Read one split file list, e.g. read_split('eigen') -> 697 lines."""
    return readlines(os.path.join(resolve_split_dir(split, data_path), which))
