"""`nyu_densenet161_640x480` on the port: DenseNet161Encoder +
NyuDecoderWave(decoder_width=0.5)."""

from __future__ import annotations

from . import common


class Server(common.Server):
    """DenseNet161Encoder + NyuDecoderWave(decoder_width=0.5); sparse masks
    at scales 1 and 0."""

    def __init__(self, weights: dict, device, params: dict):
        from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
            NyuDecoderWave
        from wavelet_monodepth_tpu_torch.models.densenet import \
            DenseNet161Encoder
        encoder = DenseNet161Encoder()
        super().__init__(encoder, NyuDecoderWave(encoder.num_ch_enc,
                                                 decoder_width=0.5),
                         weights, device, params)
