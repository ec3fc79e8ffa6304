"""`kitti_r18_640x192` on the port: ResnetEncoder(18) +
KittiWaveletDecoder for serving, KittiTrainSetup for training."""

from __future__ import annotations

import torch

from . import common


class Server(common.Server):
    """ResnetEncoder(18) + KittiWaveletDecoder; sparse masks at scales 3,
    2, 1."""

    def __init__(self, weights: dict, device, params: dict):
        from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
            KittiWaveletDecoder
        from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
        encoder = ResnetEncoder(18)
        super().__init__(encoder, KittiWaveletDecoder(encoder.num_ch_enc),
                         weights, device, params)


class Trainer:
    """`KittiTrainSetup.train_step` at the configuration's training
    settings: stereo + depth hints (frames 0 and "s", scales 0-3), the
    wavelet decoder, the stereo and hint warps the cell's `warp` parameter
    names (`stereo_warp_kernel`), Adam at lr 1e-4, float32 with TF32 off;
    the benchmark's weights loaded into the state that `init_state`
    built."""

    def __init__(self, weights: dict, device, params: dict, config: dict):
        from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
        from wavelet_monodepth_tpu_torch.utils.config import KittiOptions
        from wavelet_monodepth_tpu_torch.utils.device import pin_float32
        pin_float32(device)
        t = config["train"]
        opts = KittiOptions(
            height=config["height"], width=config["width"],
            batch_size=int(params["batch"]), frame_ids=(0,),
            use_stereo=t["use_stereo"], use_depth_hints=t["use_depth_hints"],
            use_wavelets=True, scales=tuple(t["scales"]),
            loss_scales=tuple(t["scales"]), learning_rate=t["learning_rate"],
            min_depth=t["min_depth"], max_depth=t["max_depth"],
            disparity_smoothness=t["disparity_smoothness"],
            weights_init="scratch", stereo_warp_kernel=params["warp"],
            device=device.type)
        self.setup = KittiTrainSetup(opts, device=device)
        self.state = self.setup.init_state(torch.Generator().manual_seed(0))
        self.state.encoder.load_state_dict(weights["encoder"], strict=True)
        self.state.decoder.load_state_dict(weights["decoder"], strict=True)

    def step(self, batch: dict, noise: dict) -> dict:
        return self.setup.train_step(self.state, batch, noise)

    def named_parameters(self) -> dict:
        return {n: p for m in (self.state.encoder, self.state.decoder)
                for n, p in m.named_parameters()}

    def first_gradients(self) -> dict:
        """The gradient as Adam got it at its first step (weight decay
        included), worked out from its state: exp_avg / (1 - beta1); zero
        where Adam holds no state."""
        opt = self.state.optimizer
        beta1 = {id(p): g["betas"][0] for g in opt.param_groups
                 for p in g["params"]}
        return {n: (opt.state[p]["exp_avg"] / (1.0 - beta1[id(p)])
                    if "exp_avg" in opt.state.get(p, {})
                    else torch.zeros_like(p))
                for n, p in self.named_parameters().items()}
