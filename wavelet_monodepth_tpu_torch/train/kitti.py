"""KITTI training: the model, its state, and the train and eval steps.

Counterpart of `wavelet_monodepth_tpu/train/kitti.py` (the reference's
`Trainer`, `KITTI/trainer.py:30-785`) for the stereo (+ depth hints)
configurations: ResNet18 + the KITTI wavelet decoder, f32 or bf16 mixed
precision, one card.

Where JAX returns a new state from a pure step, the port's `train_step`
updates the state in place (parameters, BN running statistics, Adam
moments, step count) and returns the step's losses as tensors on the
device, without synchronising. BN in train mode updates the running
variance with the biased batch variance, as flax does
(`models/resnet.py`). `--steps_per_call` is a plain loop of single steps
in the CLI: the JAX package's `lax.scan` amortises a TPU dispatch cost
the port does not have.

`--bfloat16` is JAX's mixed-precision step
(`make_train_step(mixed_precision=True)`): the networks run forward and
backward in bfloat16 on a bfloat16 copy of the float32 master
parameters, made inside the differentiated function, so the gradients
arrive float32 at the masters and Adam's state stays float32. Only the
("color_aug", ...) inputs are cast; the warps and geometry take the
float32 colour, intrinsics and poses (the pixel grid of the
backprojection follows depth's dtype, as in JAX: `ops/geometry.py`); BN
keeps float32 running statistics with float32 batch statistics; the
losses come back float32. The eval step runs in float32, as JAX's.

Not ported yet, and raising: pose networks (monocular and M+S configs),
the baseline decoder and the other encoders.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..models.factory import make_depth_decoder, make_depth_encoder
from ..models.layers import init_params
from ..ops import augment
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


class KittiTrainSetup:
    """Builds the modules, the initial state and the steps."""

    def __init__(self, opts: KittiOptions, steps_per_epoch: int = 1000,
                 device=None):
        """device: where the modules and steps run; None follows
        `opts.device` (the card by default), which raises without one."""
        opts.validate_for_training()
        if opts.use_pose_net:
            raise NotImplementedError(
                "pose networks are not ported yet (ROADMAP.md, Queue 1 item "
                "3: models/pose.py and the M+S pose-frame warps)")
        if opts.encoder_type != "resnet":
            raise NotImplementedError(
                f"training encoder_type={opts.encoder_type!r} is not ported "
                "yet: the ImageNet init and the trainer are ResNet-only "
                "(ROADMAP.md, Queue 1 item 3: remaining KITTI models)")
        for name, default in (("data_axis", 1), ("native_decode", False),
                              ("coordinator_address", None),
                              ("num_processes", None)):
            if getattr(opts, name) != default:
                raise NotImplementedError(
                    f"--{name} is not ported yet (ROADMAP.md, Queue 1 item 6: "
                    "multi-GPU and tools)")
        self.opts = opts
        self.device = resolve_device(opts.device if device is None
                                     else device)
        self.lr_at = steplr(opts.learning_rate, steps_per_epoch,
                            opts.scheduler_step_size)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Fresh weights (the JAX package's fan-in init, drawn from
        `generator`, seed 0 by default), the ImageNet encoder when asked
        for, the disparity-head bias, and a fresh Adam."""
        opts = self.opts
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        encoder, num_ch = make_depth_encoder(opts)
        decoder = make_depth_decoder(num_ch, opts)
        init_params(encoder, gen)
        init_params(decoder, gen)
        self._imagenet_init(encoder)
        self._disp_head_surgery(decoder)
        encoder.to(self.device)
        decoder.to(self.device)
        return TrainState(encoder, decoder,
                          make_optimizer(encoder, decoder, opts.learning_rate))

    def _imagenet_init(self, encoder: torch.nn.Module) -> None:
        """weights_init=pretrained: a local torchvision ResNet state dict
        (--imagenet_weights_path); without one, scratch init with a note
        (the reference downloads it; this code has no network)."""
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
        own = encoder.encoder.state_dict()
        fitted = {k: v for k, v in sd.items() if k in own}
        for k in own:
            if k not in fitted and k.endswith("num_batches_tracked"):
                fitted[k] = torch.zeros((), dtype=torch.long)
        encoder.encoder.load_state_dict(fitted, strict=True)
        print(f"ImageNet init: encoder from {path}")

    def _disp_head_surgery(self, decoder: torch.nn.Module) -> None:
        """disp_head_bias != 0: the LL head's conv bias starts at that
        value (the wavelet decoder's disparity is 2^i * sigmoid(LL))."""
        b = float(self.opts.disp_head_bias or 0.0)
        if b:
            with torch.no_grad():
                decoder.blocks["waveconv_4_ll"][2].conv.bias.fill_(b)

    # ------------------------------------------------------------------
    def forward(self, state: TrainState, inputs: Dict, noise, train: bool,
                params: Optional[tuple] = None):
        """`process_batch` (`trainer.py:231-252`): encoder -> decoder ->
        warps -> losses. Returns (outputs, losses). `params`, when given,
        is ({encoder name: tensor}, {decoder name: tensor}), which the
        networks run with in place of their own parameters."""
        opts = self.opts
        state.encoder.train(train)
        enc_p, dec_p = params if params is not None else (None, None)
        feats = _call(state.encoder, enc_p, inputs[("color_aug", "0", 0)])
        outputs = _call(state.decoder, dec_p, feats)
        outputs = losses_kitti.generate_images_pred(inputs, outputs, opts)
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
            params = tuple({n: p.to(torch.bfloat16)
                            for n, p in m.named_parameters()}
                           for m in (state.encoder, state.decoder))
            inputs = {k: (v.to(torch.bfloat16) if k[0] == "color_aug"
                          else v) for k, v in inputs.items()}
        _, losses = self.forward(state, inputs, noise, train=True,
                                 params=params)
        losses = cast_floats(losses, torch.float32)
        losses["loss"].backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, inputs: Dict, noise):
        """Forward with the BN running statistics; (outputs, losses)."""
        return self.forward(state, augment.expand_batch(inputs), noise,
                            train=False)


def _call(module: torch.nn.Module, params: Optional[dict], *args):
    """module(*args), with `params` in place of its parameters if given."""
    if params is None:
        return module(*args)
    return torch.func.functional_call(module, params, args)
