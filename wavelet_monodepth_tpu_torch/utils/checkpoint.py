"""Per-epoch checkpoints in the reference's layouts.

KITTI: the reference writes `<log>/models/weights_<epoch>/{encoder,depth,
pose_encoder,pose,adam}.pth` (the pose files when the run has pose nets;
PoseCNN has no pose_encoder) and `<log>/models/opt.json`
(`KITTI/trainer.py:722-785`);
`encoder.pth` carries the feed height / width / use_stereo beside the
state dict, which the inference tools read back. NYU:
`<log>/models/weights_<epoch>/{model,adam}.pth`, `model.pth` being the
reference's one state dict under `encoder.` / `decoder.`
(`NYUv2/load_save_utils.py:11-52`), and the same `opt.json`. The JAX
package stores one flax state file per folder instead
(`utils/checkpoint.py`); the port writes the reference's files, so its
`tools/infer.py`, its `tools/evaluate_nyu.py` and the reference load
them, and `latest_checkpoint` serves `--auto_resume`.

Each file is written to a temporary name and renamed, so a folder cut
off mid-save lacks a file and `latest_checkpoint` skips it.

Under data parallelism (`parallel/mesh.py`) every rank calls the savers:
rank 0 writes the files, then all ranks meet at a barrier, so none reads
a folder before it is complete. Every rank reads on resume.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..parallel import mesh
from .config import save_opts

_FILES = ("encoder.pth", "depth.pth", "adam.pth")
NYU_FILES = ("model.pth", "adam.pth")


def checkpoint_files(state) -> tuple:
    """The files a complete KITTI checkpoint of `state` holds: one per
    network (`TrainState.modules`) and adam.pth."""
    return tuple(f"{name}.pth" for name in state.modules()) + ("adam.pth",)


def _save(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _cpu(sd: dict) -> dict:
    return {k: v.detach().cpu() if torch.is_tensor(v) else v
            for k, v in sd.items()}


def save_checkpoint(log_path: str, epoch: int, state, opts) -> str:
    """Write models/weights_<epoch>/ (encoder.pth with the feed size,
    depth.pth, pose_encoder.pth and pose.pth where the state has them,
    adam.pth last) and models/opt.json on rank 0; every rank returns the
    folder once it is complete."""
    models = os.path.join(log_path, "models")
    folder = os.path.join(models, f"weights_{epoch}")
    if mesh.is_main():
        os.makedirs(folder, exist_ok=True)
        for name, module in state.modules().items():
            sd = _cpu(module.state_dict())
            if name == "encoder":
                sd.update(height=int(opts.height), width=int(opts.width),
                          use_stereo=bool(opts.use_stereo))
            _save(sd, os.path.join(folder, f"{name}.pth"))
        _save(state.optimizer.state_dict(), os.path.join(folder, "adam.pth"))
        save_opts(opts, os.path.join(models, "opt.json"))
    mesh.barrier()
    return folder


def load_checkpoint(folder: str, state,
                    models_to_load=("encoder", "depth", "pose_encoder",
                                    "pose")) -> dict:
    """Restore the chosen models that the state has (and Adam, when its
    file is there and the parameter groups match) into `state` in place,
    `trainer.py:753-785`. Returns the feed-size ints of encoder.pth."""
    meta = {}
    device = next(state.encoder.parameters()).device
    for name, module in state.modules().items():
        if name not in models_to_load:
            continue
        sd = torch.load(os.path.join(folder, f"{name}.pth"),
                        map_location=device, weights_only=True)
        for k in ("height", "width", "use_stereo"):
            if k in sd:
                meta[k] = int(sd.pop(k))
        module.load_state_dict(sd, strict=True)
    _load_adam(folder, state, device)
    return meta


def _load_adam(folder: str, state, device) -> None:
    adam = os.path.join(folder, "adam.pth")
    if os.path.exists(adam):
        sd = torch.load(adam, map_location=device, weights_only=True)
        sizes = [len(g["params"]) for g in sd["param_groups"]]
        if sizes == [len(g["params"]) for g in state.optimizer.param_groups]:
            state.optimizer.load_state_dict(sd)
        else:
            print("Can't load Adam: its parameter groups differ; "
                  "Adam is randomly initialized")


def save_nyu_checkpoint(log_path: str, epoch: int, state, opts) -> str:
    """Write models/weights_<epoch>/ (model.pth, adam.pth last) and
    models/opt.json on rank 0; every rank returns the folder once it is
    complete."""
    from ..tools.torch_import import nyu_model_state
    models = os.path.join(log_path, "models")
    folder = os.path.join(models, f"weights_{epoch}")
    if mesh.is_main():
        os.makedirs(folder, exist_ok=True)
        _save(nyu_model_state(state.encoder, state.decoder),
              os.path.join(folder, "model.pth"))
        _save(state.optimizer.state_dict(), os.path.join(folder, "adam.pth"))
        save_opts(opts, os.path.join(models, "opt.json"))
    mesh.barrier()
    return folder


def load_nyu_checkpoint(folder: str, state) -> None:
    """Restore model.pth (strict, after `tools/torch_import`'s fix-ups)
    and, when its parameter groups match, Adam into `state` in place."""
    from ..tools import torch_import as ti
    ti.load_state_dicts(state.encoder, state.decoder,
                        *ti.load_nyu_model_pth(os.path.join(folder,
                                                            "model.pth")))
    _load_adam(folder, state, next(state.encoder.parameters()).device)


def latest_checkpoint(log_path: str, files=_FILES) -> Optional[str]:
    """Newest weights_<epoch> folder that holds all of `files` (the KITTI
    set without pose nets by default; `checkpoint_files(state)` for a run
    with them; NYU_FILES for the NYU trainer's); a folder whose save was
    cut off is skipped for the one before."""
    models_dir = os.path.join(log_path, "models")
    if not os.path.isdir(models_dir):
        return None
    folders = [d for d in os.listdir(models_dir) if d.startswith("weights_")]
    folders.sort(key=lambda d: int(d.split("_")[1]), reverse=True)
    for d in folders:
        folder = os.path.join(models_dir, d)
        if all(os.path.exists(os.path.join(folder, f)) for f in files):
            return folder
    return None
