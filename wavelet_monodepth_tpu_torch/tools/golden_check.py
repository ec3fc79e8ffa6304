"""Pre-flight validator for the golden-metric release gates.

Counterpart of `wavelet_monodepth_tpu/tools/golden_check.py`, with its
mounts (the same environment variables), lines, summary and exit rule.
One command vets every GOLDEN_GATES.md mount before any eval time is
spent: data layout (the exact files the datasets will open), checkpoint
coverage (each file read through the port's importer,
`tools/torch_import.py`, shape-compared by state-dict name against a
fresh seeded port init and then loaded into the port's modules with
`strict=True`), and split/GT consistency. The gates themselves are
`tests/test_torch_port_integration_data.py`.

Prints one line per mount:

  [ OK ]  mount present and validates
  [ -- ]  env var unset (reported with where the artifact comes from)
  [FAIL]  mount present but broken (with the exact missing file/key)

Exit 0 when nothing present fails; absent mounts are only fatal with
--require_all. It runs on the CPU (no model is run). Usage:

  python -m wavelet_monodepth_tpu_torch.tools.golden_check [--require_all]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, List, Tuple

OK, ABSENT, FAIL = "[ OK ]", "[ -- ]", "[FAIL]"

# keys a checkpoint may carry that the port has no module for, dropped by
# the importer (`tools/torch_import._fit`): torchvision's classifier and
# DenseNet's unused norm5; the reference's feed-size ints are not tensors
_DROPPED = ("fc.", "original_model.features.norm5.",
            "original_model.classifier.")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def resnet_layers_of(sd: dict, prefix: str) -> int | None:
    """The torchvision resnet depth of a state dict, from its block counts
    per stage and whether its blocks are bottlenecks."""
    bottleneck = f"{prefix}layer1.0.conv3.weight" in sd

    def nblocks(li):
        n = 0
        while f"{prefix}layer{li}.{n}.conv1.weight" in sd:
            n += 1
        return n

    cfg = tuple(nblocks(i) for i in (1, 2, 3, 4))
    table = {(2, 2, 2, 2): 18, (3, 4, 6, 3): 50 if bottleneck else 34,
             (3, 4, 23, 3): 101, (3, 8, 36, 3): 152}
    return table.get(cfg)


def _seeded(*modules):
    """The modules with the port's seeded fresh init (seed 0)."""
    import torch
    from ..models.layers import init_params
    gen = torch.Generator().manual_seed(0)
    return tuple(init_params(m, gen) for m in modules)


def compare_state(sd: dict, fresh, what: str, scope: str = "") -> List[str]:
    """Shape-compare a checkpoint's state dict against a fresh module's by
    name (BatchNorm's num_batches_tracked aside: the importer fills it);
    names are reported with the file's `scope`."""
    import torch
    got = {k: tuple(v.shape) for k, v in sd.items()
           if isinstance(v, torch.Tensor)
           and not k.endswith("num_batches_tracked")}
    want = {k: tuple(v.shape) for k, v in fresh.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    missing = sorted(scope + k for k in set(want) - set(got))
    extra = sorted(scope + k for k in set(got) - set(want)
                   if not any(k.startswith(p) or k.startswith("encoder." + p)
                              for p in _DROPPED))
    mismatch = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    probs = []
    if missing:
        probs.append(f"{what}: checkpoint has no value for {len(missing)} "
                     f"param(s), e.g. {missing[:3]}")
    if extra:
        probs.append(f"{what}: checkpoint has {len(extra)} param(s) the "
                     f"model does not have, e.g. {extra[:3]}")
    for k in mismatch[:3]:
        probs.append(f"{what}: shape mismatch at {scope}{k}: "
                     f"checkpoint {got[k]} vs model {want[k]}")
    if len(mismatch) > 3:
        probs.append(f"{what}: ... and {len(mismatch) - 3} more "
                     "shape mismatches")
    return probs


def _load_strict(encoder, decoder, enc_sd, dec_sd) -> List[str]:
    """Load both into the port's modules with strict=True (after the
    importer's fix-ups); a refusal is a problem line."""
    from . import torch_import as ti
    try:
        ti.load_state_dicts(encoder, decoder, enc_sd, dec_sd)
    except RuntimeError as e:
        return [f"strict load failed: {' '.join(str(e).split())}"]
    return []


def _torch_load(path: str) -> dict:
    import torch
    return torch.load(path, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# mount checks — each returns a list of problems (empty == OK)
# ---------------------------------------------------------------------------

def check_kitti_data(root: str) -> List[str]:
    probs = []
    if not os.path.isdir(root):
        return [f"not a directory: {root}"]
    tf = os.path.join(root, "splits", "eigen", "test_files.txt")
    if not os.path.isfile(tf):
        probs.append(f"missing {tf} (vendor splits/ or symlink the "
                     "repo's splits/ under the data root)")
        return probs
    with open(tf) as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        return [f"{tf} is empty"]
    side_map = {"2": 2, "3": 3, "l": 2, "r": 3}
    for folder, frame, side in (lines[0], lines[-1]):
        stem = os.path.join(root, folder,
                            f"image_0{side_map[side]}/data",
                            f"{int(frame):010d}")
        if not any(os.path.isfile(stem + ext) for ext in (".jpg", ".png")):
            probs.append(f"image not found: {stem}.jpg|.png "
                         "(KITTI raw sync layout expected)")
    gt = os.path.join(root, "splits", "eigen", "gt_depths.npz")
    if not os.path.isfile(gt):
        probs.append(f"missing {gt} — generate with: python -m "
                     "wavelet_monodepth_tpu_torch.tools.export_gt_depth "
                     f"--data_path {root} --split eigen")
    else:
        import numpy as np
        try:
            data = np.load(gt, fix_imports=True, encoding="latin1",
                           allow_pickle=True)["data"]
            if len(data) != len(lines):
                probs.append(f"gt_depths.npz has {len(data)} maps but "
                             f"test_files.txt has {len(lines)} lines")
        except Exception as e:
            probs.append(f"gt_depths.npz unreadable: {e}")
    return probs


def check_kitti_weights(folder: str, num_layers: int, height: int,
                        width: int) -> List[str]:
    probs = []
    if not os.path.isdir(folder):
        return [f"not a directory: {folder}"]
    paths = {n: os.path.join(folder, f"{n}.pth")
             for n in ("encoder", "depth")}
    missing = [p for p in paths.values() if not os.path.isfile(p)]
    if missing:
        return [f"missing checkpoint file(s): {missing}"]
    try:
        enc_sd = _torch_load(paths["encoder"])
        dec_sd = _torch_load(paths["depth"])
    except Exception as e:
        return [f"torch.load failed: {e}"]

    for k, want in (("height", height), ("width", width)):
        if k in enc_sd and int(enc_sd[k]) != want:
            probs.append(f"encoder.pth says {k}={int(enc_sd[k])} but this "
                         f"gate expects {k}={want} — wrong weights folder?")
    got_layers = resnet_layers_of(enc_sd, "encoder.")
    if got_layers is None:
        probs.append("encoder.pth keys do not look like a torchvision "
                     "resnet under the 'encoder.' scope")
        return probs
    if got_layers != num_layers:
        probs.append(f"encoder.pth is a resnet{got_layers} but this gate "
                     f"expects resnet{num_layers}")
        return probs

    from ..models.decoders_kitti import KittiWaveletDecoder
    from ..models.resnet import ResnetEncoder
    enc = ResnetEncoder(num_layers=num_layers)
    enc, dec = _seeded(enc, KittiWaveletDecoder(num_ch_enc=enc.num_ch_enc))
    probs += compare_state(enc_sd, enc, "encoder")
    probs += compare_state(dec_sd, dec, "depth decoder")
    return probs or _load_strict(enc, dec, enc_sd, dec_sd)


def check_odom_data(root: str) -> List[str]:
    probs = []
    if not os.path.isdir(root):
        return [f"not a directory: {root}"]
    for seq in (9, 10):
        img_dir = os.path.join(root, f"sequences/{seq:02d}", "image_2")
        if not os.path.isdir(img_dir):
            probs.append(f"missing {img_dir}")
        elif not any(f.endswith(".png") for f in os.listdir(img_dir)):
            probs.append(f"no .png frames in {img_dir} (odometry "
                         "evaluation reads pngs)")
        poses = os.path.join(root, "poses", f"{seq:02d}.txt")
        if not os.path.isfile(poses):
            probs.append(f"missing {poses} (KITTI odometry GT poses)")
        else:
            import numpy as np
            try:
                arr = np.loadtxt(poses)
                if arr.ndim != 2 or arr.shape[1] != 12:
                    probs.append(f"{poses}: expected (N, 12) pose rows, "
                                 f"got {arr.shape}")
            except Exception as e:
                probs.append(f"{poses} unreadable: {e}")
    return probs


def check_pose_weights(folder: str) -> List[str]:
    probs = []
    if not os.path.isdir(folder):
        return [f"not a directory: {folder}"]
    from . import torch_import as ti
    paths = [os.path.join(folder, f"{n}.pth")
             for n in ("pose_encoder", "pose")]
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        return [f"missing checkpoint file(s): {missing}"]
    try:
        # the reference's `encoder.`-scoped layout, or JAX's unscoped one
        enc_sd, dec_sd = ti.load_pose_checkpoint(folder)
    except Exception as e:
        return [f"torch.load failed: {e}"]
    layers = resnet_layers_of(enc_sd, "encoder.")
    if layers is None:
        return ["pose_encoder.pth keys do not look like a torchvision "
                "resnet state dict"]
    conv1 = enc_sd.get("encoder.conv1.weight")
    if conv1 is not None and conv1.shape[1] != 6:
        probs.append(f"pose_encoder.pth conv1 has {conv1.shape[1]} input "
                     "channels; expected 6 (pair-of-frames pose encoder)")

    from ..models.pose import PoseDecoder
    from ..models.resnet import ResnetEncoder
    enc = ResnetEncoder(num_layers=layers, num_input_images=2)
    enc, dec = _seeded(enc, PoseDecoder(num_ch_enc=enc.num_ch_enc,
                                        num_input_features=1,
                                        num_frames_to_predict_for=2))
    probs += compare_state(enc_sd, enc, "pose encoder")
    probs += compare_state(dec_sd, dec, "pose decoder")
    return probs or _load_strict(enc, dec, enc_sd, dec_sd)


def _h5py():
    """h5py, or None: the labeled mat is HDF5 (v7.3), which only h5py
    reads here."""
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def check_nyu_mat(path: str) -> List[str]:
    if not os.path.isfile(path):
        return [f"not a file: {path} (expected nyu_depth_v2_labeled.mat)"]
    h5py = _h5py()
    if h5py is None:
        return ["h5py is not installed: the labeled mat is v7.3 (HDF5) "
                "and the NYU eval reads it with h5py"]
    try:
        with h5py.File(path, "r") as f:
            if "images" not in f or "depths" not in f:
                return ["mat file lacks 'images'/'depths' datasets "
                        "(need the v7.3 labeled mat)"]
            ish, dsh = f["images"].shape, f["depths"].shape
    except Exception as e:
        return [f"h5py cannot open it: {e} (the labeled mat is v7.3; "
                "older formats need scipy.io and are not what the "
                "pipeline reads)"]
    probs = []
    if len(ish) != 4 or ish[1] != 3:
        probs.append(f"images shape {ish}: expected (N, 3, W, H) "
                     "mat-axis order")
    if len(dsh) != 3 or dsh[0] != ish[0]:
        probs.append(f"depths shape {dsh} inconsistent with images {ish}")
    return probs


def check_nyu_splits(path: str, mat_path: str | None) -> List[str]:
    if not os.path.isfile(path):
        return [f"not a file: {path} (expected the toolbox splits.mat)"]
    from scipy.io import loadmat
    try:
        m = loadmat(path)
    except Exception as e:
        return [f"loadmat failed: {e}"]
    if "testNdxs" not in m:
        return ["splits.mat lacks 'testNdxs'"]
    idx = m["testNdxs"].ravel()
    probs = []
    if idx.min() < 1:
        probs.append("testNdxs has entries < 1 (they are 1-based)")
    if mat_path and os.path.isfile(mat_path):
        h5py = _h5py()
        if h5py is None:
            return probs + ["h5py is not installed: cannot check testNdxs "
                            "against the labeled mat's image count"]
        try:
            with h5py.File(mat_path, "r") as f:
                n = f["images"].shape[0]
            if idx.max() > n:
                probs.append(f"testNdxs max {idx.max()} exceeds the "
                             f"mat's {n} images")
        except Exception:
            pass
    return probs


def check_nyu_weights(path: str) -> List[str]:
    if not os.path.isfile(path):
        return [f"not a file: {path} (WMD_NYU_WEIGHTS points at the "
                "reference model.pth itself)"]
    from . import torch_import as ti
    try:
        enc_sd, dec_sd = ti.load_nyu_model_pth(path)
    except Exception as e:
        return [f"torch.load failed: {e}"]

    from ..models.decoders_nyu import NyuDecoderWave
    from ..models.densenet import NUM_CH_ENC, DenseNet161Encoder
    enc, dec = _seeded(DenseNet161Encoder(normalize_input=False),
                       NyuDecoderWave(num_ch_enc=NUM_CH_ENC,
                                      decoder_width=0.5))
    probs = compare_state(enc_sd, enc, "densenet encoder", "encoder.")
    probs += compare_state(dec_sd, dec, "DecoderWave", "decoder.")
    return probs or _load_strict(enc, dec, enc_sd, dec_sd)


def check_nyu_edges(root: str) -> List[str]:
    if not os.path.isdir(root):
        return [f"not a directory: {root}"]
    pngs = [f for f in os.listdir(root)
            if f.endswith(".png") and f[:-4].isdigit()]
    if not pngs:
        return ["no NNNN.png edge maps found (NYUv2-OC++ layout)"]
    return []


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

# (env var, description of what to mount, check(value, env) -> problems)
MOUNTS: List[Tuple[str, str, Callable[[str, dict], List[str]]]] = [
    ("WMD_KITTI_DATA",
     "KITTI raw root with splits/eigen/{test_files.txt,gt_depths.npz}",
     lambda v, e: check_kitti_data(v)),
    ("WMD_KITTI_WEIGHTS",
     "reference R18 640x192 folder (encoder.pth/depth.pth)",
     lambda v, e: check_kitti_weights(v, 18, 192, 640)),
    ("WMD_KITTI_WEIGHTS_R50",
     "reference R50 640x192 folder",
     lambda v, e: check_kitti_weights(v, 50, 192, 640)),
    ("WMD_KITTI_WEIGHTS_R18_1024",
     "reference R18 1024x320 folder",
     lambda v, e: check_kitti_weights(v, 18, 320, 1024)),
    ("WMD_KITTI_WEIGHTS_R50_1024",
     "reference R50 1024x320 folder",
     lambda v, e: check_kitti_weights(v, 50, 320, 1024)),
    ("WMD_KITTI_ODOM_DATA",
     "KITTI odometry root (sequences/09|10/image_2, poses/09|10.txt)",
     lambda v, e: check_odom_data(v)),
    ("WMD_KITTI_POSE_WEIGHTS",
     "pose folder (pose_encoder.pth/pose.pth, pair-input resnet)",
     lambda v, e: check_pose_weights(v)),
    ("WMD_NYU_MAT",
     "nyu_depth_v2_labeled.mat (official v7.3)",
     lambda v, e: check_nyu_mat(v)),
    ("WMD_NYU_SPLITS",
     "toolbox splits.mat with testNdxs",
     # cross-check against the mat from the SAME env mapping
     lambda v, e: check_nyu_splits(v, e.get("WMD_NYU_MAT"))),
    ("WMD_NYU_WEIGHTS",
     "reference DenseNet161 DecoderWave model.pth (the file)",
     lambda v, e: check_nyu_weights(v)),
    ("WMD_NYU_EDGES",
     "NYUv2-OC++ edge pngs dir (optional, enables the eps_acc gate)",
     lambda v, e: check_nyu_edges(v)),
]


def run_checks(env=os.environ, out=None) -> int:
    """Validate every mount; returns the number of FAILing mounts."""
    out = out if out is not None else sys.stdout
    failures = 0
    absent = 0
    for var, desc, check in MOUNTS:
        value = env.get(var)
        if not value:
            absent += 1
            print(f"{ABSENT} {var}: unset — mount {desc} "
                  "(see GOLDEN_GATES.md for the source)", file=out)
            continue
        try:
            probs = check(value, env)
        except Exception as e:  # checker crash is a finding, not a crash
            probs = [f"validator error: {type(e).__name__}: {e}"]
        if probs:
            failures += 1
            print(f"{FAIL} {var} = {value}", file=out)
            for p in probs:
                print(f"       - {p}", file=out)
        else:
            print(f"{OK} {var} = {value}", file=out)
    n = len(MOUNTS)
    print(f"\n{n - failures - absent}/{n} mounts OK, {absent} absent, "
          f"{failures} failing.", file=out)
    if failures == 0 and absent == 0:
        print("All mounts validate — run the port's gates:\n"
              "  python -m pytest tests/test_torch_port_integration_data.py"
              " -v", file=out)
    return failures


def main(argv=None, env=None, out=None) -> int:
    """Returns the exit code: 1 when a present mount fails, or with
    --require_all when one is absent; else 0. `env` defaults to the
    process environment."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--require_all", action="store_true",
                   help="exit nonzero if any mount is absent, not just "
                        "broken")
    args = p.parse_args(argv)
    env = os.environ if env is None else env
    failures = run_checks(env, out)
    absent = sum(1 for var, _, _ in MOUNTS if not env.get(var))
    if failures or (args.require_all and absent):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
