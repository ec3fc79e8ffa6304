"""Network factory: counterpart of `wavelet_monodepth_tpu/models/factory.py`
(`KITTI/networks/network_constructors.py:12-64`) for what the port has,
the ResNet encoders (18/34/50/101/152) and the KITTI wavelet decoder; the
rest raises naming the ROADMAP item that ports it."""

from __future__ import annotations

from .decoders_kitti import KittiWaveletDecoder
from .resnet import ResnetEncoder, num_ch_enc as resnet_ch


def make_depth_encoder(opts):
    """(encoder module, num_ch_enc)."""
    if opts.encoder_type != "resnet":
        raise NotImplementedError(
            f"encoder_type={opts.encoder_type!r} is not ported yet (ROADMAP.md, "
            "Queue 1 item 3: remaining KITTI models)")
    return ResnetEncoder(num_layers=opts.num_layers), resnet_ch(opts.num_layers)


def make_depth_decoder(num_ch_enc, opts):
    if not opts.use_wavelets:
        raise NotImplementedError(
            "the baseline DepthDecoder (no --use_wavelets) is not ported yet "
            "(ROADMAP.md, Queue 1 item 3: remaining KITTI models)")
    return KittiWaveletDecoder(num_ch_enc=tuple(num_ch_enc))
