"""KITTI options, flag for flag with the JAX package's CLI.

Counterpart of `KittiOptions` / `parse_kitti_args` in
`wavelet_monodepth_tpu/utils/config.py` (the reference's
`KITTI/options.py`), with the same fields, defaults and flag parsing
(`--flag` / `--no-flag` for bools, lists for tuples), plus the port's
`device`; and `NyuOptions` / `parse_nyu_args`, the whole NYUv2 dataclass
(`NYUv2/train.py:167-199`, `evaluate.py:19-51`), its training fields
included, plus the port's `device`. `opt.json` beside the checkpoints is
`save_opts`' dump.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass
class KittiOptions:
    # PATHS
    data_path: str = "kitti_data"
    depth_data_path: str = "kitti_data"
    log_dir: str = "log"
    # TRAINING
    model_name: str = "mdp"
    split: str = "eigen_zhou"
    num_layers: int = 18
    encoder_type: str = "resnet"           # resnet | mobilenet | mobilenet_light
    dataset: str = "kitti"                 # kitti | kitti_odom | kitti_depth
    png: bool = False
    height: int = 192
    width: int = 640
    disparity_smoothness: float = 1e-3
    smoothness_gamma: float = 2.0
    scales: tuple = (0, 1, 2, 3)
    loss_scales: tuple = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 100.0
    use_stereo: bool = False
    frame_ids: tuple = (0, -1, 1)
    use_wavelets: bool = False
    use_sparse: bool = False
    threshold: float = 0.05
    use_depth_hints: bool = False
    depth_hint_path: Optional[str] = None
    # OPTIMIZATION
    batch_size: int = 12
    learning_rate: float = 1e-4
    start_epoch: int = 0
    num_epochs: int = 20
    scheduler_step_size: int = 15
    # ABLATION
    v1_multiscale: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    no_ssim: bool = False
    weights_init: str = "pretrained"       # pretrained | scratch
    imagenet_weights_path: Optional[str] = None  # local torchvision resnet state_dict (.pth) for weights_init=pretrained; unset: scratch init, noted at startup
    pose_model_input: str = "pairs"        # pairs | all
    pose_model_type: str = "separate_resnet"  # posecnn|separate_resnet|shared
    # SYSTEM
    num_workers: int = 4
    # LOADING
    load_weights_folder: Optional[str] = None
    models_to_load: tuple = ("encoder", "depth", "pose_encoder", "pose")
    # LOGGING
    log_frequency: int = 250
    save_frequency: int = 1
    # EVALUATION
    eval_stereo: bool = False
    eval_mono: bool = False
    disable_median_scaling: bool = False
    pred_depth_scale_factor: float = 1.0
    ext_disp_to_eval: Optional[str] = None
    eval_split: str = "eigen"
    save_pred_disps: bool = False
    no_eval: bool = False
    eval_out_dir: Optional[str] = None
    post_process: bool = False
    # additions of the JAX package
    data_axis: int = 1                     # data-parallel rank count: N > 1 starts N ranks on this host, one per visible card (parallel/mesh.py)
    bfloat16: bool = False                 # bf16 mixed precision: the networks run in bf16 over f32 master params and Adam state (train/kitti.py)
    native_decode: bool = False            # eval feed via the C++ threaded decoder (data/native_loader.py; cv2 LANCZOS4 vs PIL LANCZOS differ ~1e-3/px); the trainer refuses it
    stereo_warp_kernel: str = "auto"       # "s"-frame/hint warp: "auto"/"off" = F.grid_sample, "on" = the banded warp kernel (ops/warp.py)
    checkpoint_backend: str = "msgpack"    # the JAX package's state format; the port writes the reference's .pth folders whatever this says
    auto_resume: bool = False              # restore the newest weights_<epoch> under log_dir/model_name and continue from epoch+1 (--load_weights_folder wins)
    hint_disp_l1_weight: float = 0.0       # opt-in scratch-training stabilizer: weight * masked L1 between each scale's disparity and the hint disparity ("disp_hint",). 0 = reference semantics
    hint_disp_l1_space: str = "log"        # "log" = |log(disp+c) - log(hint+c)|, c=0.02; "disp" = plain L1
    disp_head_bias: float = 0.0            # init-time: set the disparity-head conv bias (e.g. -4). 0 = untouched init
    host_augment: bool = False             # jitter + float cast on the host (PIL); default ships uint8 frames and jitters on the card (ops/augment.py)
    log_always: bool = False               # keep the early log cadence (every log_frequency steps) for the whole run
    steps_per_call: int = 1                # K optimizer steps per loop turn (a plain loop of single steps; drop-last on the per-epoch remainder)
    coordinator_address: Optional[str] = None  # multi-host: host:port of the store that process 0's first rank serves
    num_processes: Optional[int] = None        # multi-host: the number of hosts (each starts one rank per visible card)
    process_id: Optional[int] = None           # multi-host: this host's index; global rank = process_id * local ranks + local rank
    # the port's own
    device: str = "cuda"                   # cuda (raises without a card) | cpu

    def validate_for_training(self):
        """The reference's constructor checks (`trainer.py:35-61`)."""
        checks = [
            (not self.use_sparse,
             "Training with sparse convolution is not implemented"),
            (self.height % 32 == 0, "'height' must be a multiple of 32"),
            (self.width % 32 == 0, "'width' must be a multiple of 32"),
            (self.frame_ids[0] == 0, "frame_ids must start with 0"),
            (not self.use_depth_hints or self.use_stereo
             or "s" in self.frame_ids,
             "Can't use depth hints without training from stereo"),
            (not (self.use_depth_hints and self.v1_multiscale),
             "--v1_multiscale is incompatible with --use_depth_hints"),
            (self.steps_per_call >= 1, "steps_per_call must be >= 1"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

    @property
    def all_frame_ids(self) -> tuple:
        """frame_ids with 's' appended under stereo (`trainer.py:55-56`)."""
        if self.use_stereo and "s" not in self.frame_ids:
            return tuple(self.frame_ids) + ("s",)
        return tuple(self.frame_ids)

    @property
    def use_pose_net(self) -> bool:
        return not (self.use_stereo and tuple(self.frame_ids) == (0,))


@dataclass
class NyuOptions:
    data_path: str = "nyu_data.zip"
    log_dir: str = "log"
    model_name: str = "nyu"
    encoder_type: str = "densenet"   # densenet|resnet|mobilenet|mobilenet_light
    num_layers: int = 161
    epochs: int = 20
    lr: float = 1e-4
    batch_size: int = 8
    use_wavelets: bool = False
    use_sparse: bool = False
    use_224: bool = False
    dw_waveconv: bool = False
    dw_upconv: bool = False
    normalize_input: bool = False          # the reference's flag is a silent no-op (its encoders normalise out of place), so published NYU models saw raw [0, 1] inputs; True is real ImageNet normalisation, never for reference checkpoints
    pretrained_encoder: bool = True        # ImageNet encoder init from --imagenet_weights_path (a local file); without one, scratch init
    imagenet_weights_path: Optional[str] = None  # local torchvision densenet161 / resnet state dict (.pth)
    disparity: bool = False
    supervise_LL: bool = False
    loss_scales: tuple = (0, 1, 2, 3)
    threshold: float = 0.1
    log_frequency: int = 300
    num_workers: int = 4
    load_weights_folder: Optional[str] = None
    # additions of the JAX package
    data_axis: int = 1                     # data-parallel rank count: N > 1 starts N ranks on this host, one per visible card (parallel/mesh.py)
    bfloat16: bool = False
    checkpoint_backend: str = "msgpack"    # the JAX package's state format
    auto_resume: bool = False              # restore the newest weights_<epoch> under log_dir/model_name and continue from epoch+1 (--load_weights_folder wins)
    float_feed: bool = False               # cast and clamp on the host (the reference's ToTensor); default ships uint8 and casts on the card
    coordinator_address: Optional[str] = None  # multi-host: host:port of the store that process 0's first rank serves
    num_processes: Optional[int] = None        # multi-host: the number of hosts (each starts one rank per visible card)
    process_id: Optional[int] = None           # multi-host: this host's index; global rank = process_id * local ranks + local rank
    # the port's own
    device: str = "cuda"                   # cuda (raises without a card) | cpu


def save_opts(opts, path: str):
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(opts), f, indent=2, default=str)


def load_opts(cls, path: str):
    with open(path) as f:
        d = json.load(f)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in names})


def _add_dataclass_args(parser: argparse.ArgumentParser, cls):
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=f.default)
        elif isinstance(f.default, tuple):
            parser.add_argument(name, nargs="+", default=list(f.default))
        else:
            typ = type(f.default) if f.default is not None else str
            parser.add_argument(name, type=typ, default=f.default)


def parse_kitti_args(argv=None) -> KittiOptions:
    parser = argparse.ArgumentParser(description="WaveletMonoDepth KITTI "
                                                 "options (PyTorch port)")
    _add_dataclass_args(parser, KittiOptions)
    ns = parser.parse_args(argv)
    kw = {f.name: getattr(ns, f.name) for f in
          dataclasses.fields(KittiOptions)}
    for k in ("scales", "loss_scales", "frame_ids", "models_to_load"):
        kw[k] = tuple(int(v) if str(v).lstrip("-").isdigit() else v
                      for v in kw[k])
    return KittiOptions(**kw)


def parse_nyu_args(argv=None) -> NyuOptions:
    parser = argparse.ArgumentParser(description="WaveletMonoDepth NYUv2 "
                                                 "options (PyTorch port)")
    _add_dataclass_args(parser, NyuOptions)
    ns = parser.parse_args(argv)
    kw = {f.name: getattr(ns, f.name) for f in
          dataclasses.fields(NyuOptions)}
    kw["loss_scales"] = tuple(int(v) for v in kw["loss_scales"])
    return NyuOptions(**kw)
