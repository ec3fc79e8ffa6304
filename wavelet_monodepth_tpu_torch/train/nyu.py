"""NYUv2 supervised training: the model, its state, and the train and eval
steps.

Counterpart of `wavelet_monodepth_tpu/train/nyu.py` (the reference's
`NYUv2/train.py:165-352`): Adam(lr, 0.9, 0.999, 1e-8) without weight
decay (`:241`); loss = sum over the loss scales of 0.1 * L1 between the
scale's output, upsampled x2^s with align_corners=True, and the target
(`:298-314`); optionally the LL term, |LL3 - DWT_J=4(target) LL| / 2^4
(`:316-323`). `--disparity` trains on DepthNorm(depth) = 10 / depth
(`NYUv2/utils.py:24`; train depths are in centimetres). The 640x480
NyuDecoderWave has no ("wavelets", 3, "LL") output, so it gets no LL
term (the reference's caught KeyError); the 224 decoder does.

As in `train/kitti.py`, `train_step` updates the state in place
(parameters, BN running statistics with flax's biased variance, Adam's
moments, the step count) and returns the losses as tensors on the
device. The training decoder is dense, so no kernel of the repo runs on
this path.

`--bfloat16` is JAX's mixed-precision step: the networks run forward and
backward in bfloat16 on a bfloat16 copy of the float32 master
parameters, made inside the differentiated function, so the gradients
arrive float32 at the masters and Adam's state stays float32. The image
is cast to bfloat16; BN keeps float32 running statistics; the target and
the losses stay float32. The eval step runs in float32.

Under data parallelism (`parallel/mesh.py`) each rank holds its rows of
the global batch: BN's statistics and the L1 and LL means are the global
batch's (`mesh.global_mean`), and one all-reduce after backward averages
the gradients, so every rank takes JAX's data-mesh step.

`input_hw` and `depth_hw` are the feed's sizes (the CLI's loader makes
them; tests shrink them as the JAX package's do).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.factory import make_nyu_decoder, make_nyu_encoder
from ..models.layers import init_params
from ..ops import augment
from ..ops.image import resize_bilinear
from ..ops.wavelets import haar_dwt_J
from ..parallel import mesh
from ..utils.config import NyuOptions
from ..utils.device import resolve_device
from ..utils.precision import cast_floats
from .kitti import TrainState, call_module

Tensor = torch.Tensor


def depth_norm(depth: Tensor, max_depth: float = 10.0) -> Tensor:
    return max_depth / depth


class NyuTrainSetup:
    """Builds the modules, the initial state and the steps."""

    def __init__(self, opts: NyuOptions, device=None):
        """device: where the modules and steps run; None follows
        `opts.device` (the card by default), which raises without one.
        opts.data_axis must equal the ranks of the process group (1
        without one)."""
        mesh.require_ranks(opts.data_axis)
        self.opts = opts
        self.device = resolve_device(opts.device if device is None
                                     else device)
        self.input_hw = (224, 224) if opts.use_224 else (480, 640)
        self.depth_hw = (224, 224) if opts.use_224 else (240, 320)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Fresh weights (the JAX package's fan-in init, drawn from
        `generator`, seed 0 by default), the ImageNet encoder when asked
        for, and a fresh Adam."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        encoder, num_ch = make_nyu_encoder(self.opts)
        decoder = make_nyu_decoder(num_ch, self.opts)
        init_params(encoder, gen)
        init_params(decoder, gen)
        self._imagenet_init(encoder)
        encoder.to(self.device)
        decoder.to(self.device)
        optimizer = torch.optim.Adam(
            list(encoder.parameters()) + list(decoder.parameters()),
            lr=self.opts.lr, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(encoder, decoder, optimizer)

    def _imagenet_init(self, encoder: torch.nn.Module) -> None:
        """pretrained_encoder (reference `model.py:19-29`): the encoder
        from a local torchvision densenet / resnet state dict
        (--imagenet_weights_path); without one, scratch init with a note
        (the reference downloads it; this code has no network)."""
        opts = self.opts
        if not opts.pretrained_encoder:
            return
        path = opts.imagenet_weights_path
        if not path:
            print("pretrained_encoder requested but no "
                  "--imagenet_weights_path: scratch init (no network "
                  "egress; point it at a local torchvision state_dict, or "
                  "pass --no-pretrained_encoder)")
            return
        if opts.encoder_type not in ("densenet", "resnet"):
            raise SystemExit(
                f"--imagenet_weights_path has no {opts.encoder_type} "
                "importer mapping (densenet/resnet supported); pass "
                "--no-pretrained_encoder")
        from ..tools import torch_import as ti
        sd = torch.load(path, map_location="cpu", weights_only=True)
        ti.load_imagenet_encoder(encoder, sd, opts.encoder_type)
        print(f"ImageNet init: {opts.encoder_type} encoder from {path}")

    # ------------------------------------------------------------------
    def forward(self, state: TrainState, image: Tensor, train: bool,
                params: Optional[tuple] = None) -> Dict:
        """encoder -> decoder (dense); BN in train mode when `train`.
        `params`, when given, is ({encoder name: tensor}, {decoder name:
        tensor}), which the networks run with in place of their own."""
        state.encoder.train(train)
        state.decoder.train(train)
        enc_p, dec_p = params if params is not None else (None, None)
        return call_module(state.decoder, dec_p,
                           call_module(state.encoder, enc_p, image))

    def compute_losses(self, outputs: Dict, depth_n: Tensor) -> Dict:
        opts = self.opts
        losses: Dict = {}
        total = 0.0
        for scale in [s for s in range(4) if ("disp", s) in outputs]:
            pred = outputs[("disp", scale)]
            if scale > 0:
                pred = resize_bilinear(pred, pred.shape[1] * 2 ** scale,
                                       pred.shape[2] * 2 ** scale,
                                       align_corners=True)
            l_depth = mesh.global_mean(torch.abs(pred - depth_n))
            loss = 0.1 * l_depth
            if scale in opts.loss_scales:
                total = total + loss
            losses[f"loss/{scale}"] = loss
            losses[f"loss_depth/{scale}"] = l_depth
        if opts.use_wavelets and ("wavelets", 3, "LL") in outputs:
            yl_gt, _ = haar_dwt_J(depth_n, 4)
            l_ll = mesh.global_mean(torch.abs(outputs[("wavelets", 3, "LL")]
                                              - yl_gt)) / (2.0 ** 4)
            losses["loss_LL3"] = l_ll
            if opts.supervise_LL:
                total = total + l_ll
        losses["loss"] = total
        return losses

    def targets(self, depth: Tensor) -> Tensor:
        """The loss target of a (float) depth batch."""
        return depth_norm(depth) if self.opts.disparity else depth

    def train_step(self, state: TrainState, image: Tensor,
                   depth: Tensor) -> Dict:
        """One optimizer step in place on a uint8 or float batch; returns
        the detached losses. The gradients stay in the parameters' .grad
        until the next step."""
        image, depth = augment.expand_nyu(image, depth)
        depth_n = self.targets(depth)
        state.optimizer.zero_grad(set_to_none=True)
        params = None
        if self.opts.bfloat16:
            # the bf16 copies are made here, under autograd, so backward
            # casts each gradient back to its float32 master
            params = tuple({n: p.to(torch.bfloat16)
                            for n, p in m.named_parameters()}
                           for m in (state.encoder, state.decoder))
            image = image.to(torch.bfloat16)
        outputs = self.forward(state, image, train=True, params=params)
        losses = cast_floats(self.compute_losses(outputs, depth_n),
                             torch.float32)
        losses["loss"].backward()
        mesh.allreduce_gradients(p for g in state.optimizer.param_groups
                                 for p in g["params"])
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, image: Tensor) -> Dict:
        """Forward with the BN running statistics, float32."""
        return self.forward(state, augment.expand_nyu(image), train=False)
