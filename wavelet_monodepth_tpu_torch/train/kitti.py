"""KITTI training: the model, its state, and the train and eval steps.

Counterpart of `wavelet_monodepth_tpu/train/kitti.py` (the reference's
`Trainer`, `KITTI/trainer.py:30-785`): the ResNet or MobileNetV2
encoder, the KITTI wavelet or baseline decoder, and for monocular and
mono+stereo (M+S) training the pose networks ("separate_resnet": a
ResNet over the stacked frames + PoseDecoder; "posecnn"), in "pairs" or
"all" mode; f32 or bf16 mixed precision, on one card or data-parallel
over ranks.

Where JAX returns a new state from a pure step, the port's `train_step`
updates the state in place (parameters, BN running statistics, Adam
moments, step count) and returns the step's losses as tensors on the
device, without synchronising. BN in train mode updates the running
variance with the biased batch variance, as flax does
(`models/resnet.py`). `--steps_per_call` is a plain loop of single steps
in the CLI: the JAX package's `lax.scan` amortises a TPU dispatch cost
the port does not have.

Under data parallelism (`parallel/mesh.py`; JAX's data mesh) each rank
holds its rows of the global batch: BN's statistics, the loss terms and
the automask noise are the global batch's, and after backward one
bucketed all-reduce averages the gradients (the pose encoder runs once
per pair, so DDP's per-parameter hooks would fire twice), so every rank
takes the same step, and its parameters, BN statistics and Adam state
stay equal to the other ranks'.

`--bfloat16` is JAX's mixed-precision step
(`make_train_step(mixed_precision=True)`): the networks, the pose nets
included, run forward and backward in bfloat16 on a bfloat16 copy of the
float32 master parameters, made inside the differentiated function, so
the gradients arrive float32 at the masters and Adam's state stays
float32. Only the ("color_aug", ...) inputs are cast; the warps and
geometry take the float32 colour and intrinsics, and the pose nets'
bfloat16 poses are promoted to float32 where they meet the intrinsics
(the pixel grid of the backprojection follows depth's dtype, as in JAX:
`ops/geometry.py`); BN keeps float32 running statistics with float32
batch statistics; the losses come back float32. The eval step runs in
float32, as JAX's.

Raising, as JAX cannot run them: pose_model_type "shared" and the
ImageNet start of a MobileNetV2 encoder (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..models.factory import (make_depth_decoder, make_depth_encoder,
                              make_posenet)
from ..models.layers import init_params
from ..ops import augment
from ..ops.geometry import transformation_from_parameters
from ..parallel import mesh
from ..utils.config import KittiOptions
from ..utils.device import resolve_device
from ..utils.precision import cast_floats
from . import losses_kitti
from .optim import make_optimizer, steplr


@dataclass
class TrainState:
    encoder: torch.nn.Module
    decoder: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    pose_encoder: Optional[torch.nn.Module] = None
    pose: Optional[torch.nn.Module] = None

    def modules(self) -> Dict[str, torch.nn.Module]:
        """The networks by the reference's model names (its checkpoint
        files): encoder, depth, and pose_encoder / pose where present."""
        named = {"encoder": self.encoder, "depth": self.decoder,
                 "pose_encoder": self.pose_encoder, "pose": self.pose}
        return {k: m for k, m in named.items() if m is not None}


class KittiTrainSetup:
    """Builds the modules, the initial state and the steps."""

    def __init__(self, opts: KittiOptions, steps_per_epoch: int = 1000,
                 device=None):
        """device: where the modules and steps run; None follows
        `opts.device` (the card by default), which raises without one.
        opts.data_axis must equal the ranks of the process group (1
        without one)."""
        opts.validate_for_training()
        if opts.native_decode:
            # JAX's trainer accepts the flag and never reads it; a flag
            # that silently does nothing is refused here
            raise NotImplementedError(
                "--native_decode is an evaluation flag: the JAX package's "
                "trainer does not read it (only its tools/evaluate_depth.py "
                "and tools/serve_artifact.py do), so training refuses it; "
                "tools/evaluate_depth.py --native_decode takes it")
        mesh.require_ranks(opts.data_axis)
        if (opts.weights_init == "pretrained" and opts.imagenet_weights_path
                and opts.encoder_type != "resnet"):
            raise NotImplementedError(
                f"the ImageNet start of encoder_type={opts.encoder_type!r} "
                "is not ported: JAX imports ResNet keys into it and fails "
                "at its first apply (ROADMAP.md, Queue 3: JAX's KITTI "
                "ImageNet start on MobileNetV2); train it from scratch")
        self.opts = opts
        self.device = resolve_device(opts.device if device is None
                                     else device)
        self.frame_ids = opts.all_frame_ids
        self.num_pose_frames = (2 if opts.pose_model_input == "pairs"
                                else len(opts.frame_ids))
        self.lr_at = steplr(opts.learning_rate, steps_per_epoch,
                            opts.scheduler_step_size)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Fresh weights (the JAX package's fan-in init, drawn from
        `generator`, seed 0 by default, in the order encoder, depth,
        pose_encoder, pose), the ImageNet encoders when asked for, the
        disparity-head bias, and a fresh Adam."""
        opts = self.opts
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        encoder, num_ch = make_depth_encoder(opts)
        decoder = make_depth_decoder(num_ch, opts)
        pose_encoder = pose = None
        if opts.use_pose_net:
            pose_encoder, pose = make_posenet(opts, self.num_pose_frames,
                                              len(opts.frame_ids))
        pose_modules = [m for m in (pose_encoder, pose) if m is not None]
        for m in [encoder, decoder] + pose_modules:
            init_params(m, gen)
        self._imagenet_init(encoder, pose_encoder)
        self._disp_head_surgery(decoder)
        for m in [encoder, decoder] + pose_modules:
            m.to(self.device)
        return TrainState(encoder, decoder,
                          make_optimizer(encoder, decoder, opts.learning_rate,
                                         pose_modules=pose_modules),
                          pose_encoder=pose_encoder, pose=pose)

    def _imagenet_init(self, encoder: torch.nn.Module,
                       pose_encoder: Optional[torch.nn.Module]) -> None:
        """weights_init=pretrained: the depth encoder from a local
        torchvision ResNet state dict (--imagenet_weights_path), and the
        pose encoder from the same with its stem tiled over the frames
        (`resnet_encoder.py:55`); without one, scratch init with a note
        (the reference downloads it; this code has no network)."""
        from ..tools import torch_import as ti
        opts = self.opts
        if opts.weights_init != "pretrained":
            return
        path = opts.imagenet_weights_path
        if not path:
            print("weights_init=pretrained but no --imagenet_weights_path: "
                  "scratch init (no network egress; point it at a local "
                  "torchvision resnet state_dict to reproduce the "
                  "reference's ImageNet start)")
            return
        sd = torch.load(path, map_location="cpu", weights_only=True)
        ti.load_imagenet_encoder(encoder, sd, "resnet")
        if pose_encoder is not None:
            ti.load_imagenet_encoder(
                pose_encoder, ti.multiimage_imagenet(sd, self.num_pose_frames),
                "resnet")
        print(f"ImageNet init: encoder"
              f"{' + pose_encoder' if pose_encoder is not None else ''} "
              f"from {path}")

    def _disp_head_surgery(self, decoder: torch.nn.Module) -> None:
        """disp_head_bias != 0: every disparity head's conv bias starts at
        that value: the wavelet decoder's LL head (its disparity is
        2^i * sigmoid(LL)) and the baseline's dispconv_i."""
        b = float(self.opts.disp_head_bias or 0.0)
        if not b:
            return
        heads = [m[2].conv if name == "waveconv_4_ll" else m.conv
                 for name, m in decoder.blocks.items()
                 if name == "waveconv_4_ll" or name.startswith("dispconv_")]
        if not heads:
            raise ValueError("disp_head_bias set but no disparity head found")
        with torch.no_grad():
            for conv in heads:
                conv.bias.fill_(b)

    # ------------------------------------------------------------------
    def _pose_forward(self, state: TrainState, params: dict,
                      pose_in: torch.Tensor):
        """(axisangle, translation) of the stacked frames `pose_in`."""
        if state.pose_encoder is not None:
            pfeats = call_module(state.pose_encoder,
                                 params.get("pose_encoder"), pose_in)
            return call_module(state.pose, params.get("pose"), [pfeats])
        return call_module(state.pose, params.get("pose"), pose_in)

    def predict_poses(self, state: TrainState, inputs: Dict,
                      params: Optional[dict] = None) -> Dict:
        """`trainer.py:254-310`. "pairs": one pass per temporal frame f_i
        over [f_i, 0] (f_i < 0, the pose inverted) or [0, f_i]; "all": one
        pass over every temporal frame stacked, frame idx's pose at
        [:, idx]. Returns ("axisangle" / "translation" / "cam_T_cam", 0,
        f_i) for each temporal frame."""
        params = params or {}
        out = {}
        if self.num_pose_frames == 2:
            # JAX applies the pose encoder to each pair from the step's
            # incoming BN statistics and keeps the last pair's update (the
            # reference updates them once per pair): each pass here starts
            # from the statistics the step found
            enc = state.pose_encoder
            saved = ([b.clone() for b in enc.buffers()]
                     if enc is not None and enc.training else None)
            color0 = inputs[("color_aug", "0", 0)]
            for f_i in self.frame_ids[1:]:
                if f_i == "s":
                    continue
                if saved is not None:
                    with torch.no_grad():
                        for b, v in zip(enc.buffers(), saved):
                            b.copy_(v)
                other = inputs[("color_aug", str(f_i), 0)]
                pair = [other, color0] if f_i < 0 else [color0, other]
                aa, tr = self._pose_forward(state, params,
                                            torch.cat(pair, dim=-1))
                out[("axisangle", 0, f_i)] = aa
                out[("translation", 0, f_i)] = tr
                out[("cam_T_cam", 0, f_i)] = transformation_from_parameters(
                    aa[:, 0], tr[:, 0], invert=f_i < 0)
            return out
        pose_in = torch.cat([inputs[("color_aug", str(f), 0)]
                             for f in self.frame_ids if f != "s"], dim=-1)
        aa, tr = self._pose_forward(state, params, pose_in)
        for idx, f_i in enumerate(self.frame_ids[1:]):
            if f_i == "s":
                continue
            out[("axisangle", 0, f_i)] = aa
            out[("translation", 0, f_i)] = tr
            out[("cam_T_cam", 0, f_i)] = transformation_from_parameters(
                aa[:, idx], tr[:, idx])
        return out

    def forward(self, state: TrainState, inputs: Dict, noise, train: bool,
                params: Optional[dict] = None):
        """`process_batch` (`trainer.py:231-252`): encoder -> decoder ->
        pose -> warps -> losses. Returns (outputs, losses). `params`, when
        given, maps model names (`TrainState.modules`) to {parameter
        name: tensor}, which those networks run with in place of their
        own parameters. BN runs in train mode when `train`, else on its
        running statistics, in both encoders."""
        opts = self.opts
        params = params or {}
        for m in (state.encoder, state.pose_encoder):
            if m is not None:
                m.train(train)
        feats = call_module(state.encoder, params.get("encoder"),
                            inputs[("color_aug", "0", 0)])
        outputs = call_module(state.decoder, params.get("depth"), feats)
        pose_T = None
        if state.pose is not None:
            pose_T = self.predict_poses(state, inputs, params)
            outputs.update(pose_T)
        outputs = losses_kitti.generate_images_pred(inputs, outputs, opts,
                                                    pose_T)
        if opts.use_depth_hints:
            losses = losses_kitti.compute_losses_hints(inputs, outputs, opts,
                                                       noise)
        else:
            losses = losses_kitti.compute_losses_mdp(inputs, outputs, opts,
                                                     noise)
        return outputs, losses

    def train_step(self, state: TrainState, inputs: Dict, noise) -> Dict:
        """One optimizer step in place; returns the detached losses. The
        gradients stay in the parameters' .grad until the next step."""
        inputs = augment.expand_batch(inputs)
        for group in state.optimizer.param_groups:
            group["lr"] = self.lr_at(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        params = None
        if self.opts.bfloat16:
            # the bf16 copies are made here, under autograd, so backward
            # casts each gradient back to its float32 master
            params = {name: {n: p.to(torch.bfloat16)
                             for n, p in m.named_parameters()}
                      for name, m in state.modules().items()}
            inputs = {k: (v.to(torch.bfloat16) if k[0] == "color_aug"
                          else v) for k, v in inputs.items()}
        _, losses = self.forward(state, inputs, noise, train=True,
                                 params=params)
        losses = cast_floats(losses, torch.float32)
        losses["loss"].backward()
        mesh.allreduce_gradients(p for g in state.optimizer.param_groups
                                 for p in g["params"])
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, inputs: Dict, noise):
        """Forward with the BN running statistics; (outputs, losses)."""
        return self.forward(state, augment.expand_batch(inputs), noise,
                            train=False)


def call_module(module: torch.nn.Module, params: Optional[dict], *args):
    """module(*args), with `params` in place of its parameters if given."""
    if params is None:
        return module(*args)
    return torch.func.functional_call(module, params, args)
