"""KITTI training: the model, its state, and the train and eval steps.

Counterpart of `wavelet_monodepth_tpu/train/kitti.py` (the reference's
`Trainer`, `KITTI/trainer.py:30-785`) for the stereo (+ depth hints)
configurations: ResNet18 + the KITTI wavelet decoder, f32, one card.

Where JAX returns a new state from a pure step, the port's `train_step`
updates the state in place (parameters, BN running statistics, Adam
moments, step count) and returns the step's losses as tensors on the
device, without synchronising. BN in train mode updates the running
variance with the biased batch variance, as flax does
(`models/resnet.py`). `--steps_per_call` is a plain loop of single steps
in the CLI: the JAX package's `lax.scan` amortises a TPU dispatch cost
the port does not have.

Not ported yet, and raising: pose networks (monocular and M+S configs),
bf16 mixed precision, the baseline decoder and the other encoders.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..models.factory import make_depth_decoder, make_depth_encoder
from ..models.layers import init_params
from ..ops import augment
from ..utils.config import KittiOptions
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
                 device="cpu"):
        opts.validate_for_training()
        if opts.bfloat16:
            raise NotImplementedError(
                "--bfloat16 training is not ported yet (ROADMAP.md, "
                "follow-ups of the training slice: bf16 mixed precision)")
        if opts.use_pose_net:
            raise NotImplementedError(
                "pose networks are not ported yet (ROADMAP.md, Queue 1 item "
                "3: models/pose.py and the M+S pose-frame warps)")
        for name, default in (("data_axis", 1), ("native_decode", False),
                              ("coordinator_address", None),
                              ("num_processes", None)):
            if getattr(opts, name) != default:
                raise NotImplementedError(
                    f"--{name} is not ported yet (ROADMAP.md, Queue 1 item 6: "
                    "multi-GPU and tools)")
        self.opts = opts
        self.device = torch.device(device)
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
    def forward(self, state: TrainState, inputs: Dict, noise, train: bool):
        """`process_batch` (`trainer.py:231-252`): encoder -> decoder ->
        warps -> losses. Returns (outputs, losses)."""
        opts = self.opts
        state.encoder.train(train)
        feats = state.encoder(inputs[("color_aug", "0", 0)])
        outputs = state.decoder(feats)
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
        _, losses = self.forward(state, inputs, noise, train=True)
        losses["loss"].backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, inputs: Dict, noise):
        """Forward with the BN running statistics; (outputs, losses)."""
        return self.forward(state, augment.expand_batch(inputs), noise,
                            train=False)
