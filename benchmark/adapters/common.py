"""What the configurations' serving adapters share: one request through
an encoder and a decoder of the port, in the benchmark's own spans."""

from __future__ import annotations

import torch
from torch.profiler import record_function


class Server:
    """One request: the encoder's features of the (N, H, W, 3) float
    batch, then the decoder, dense (`masks` None) or sparse on
    `params["backend"]` (which every sparse cell names) with the
    benchmark's raw masks as `mask_override`.
    A configuration's adapter builds `encoder` and `decoder` and loads the
    benchmark's weights into them with `strict=True`."""

    def __init__(self, encoder, decoder, weights: dict, device,
                 params: dict):
        from wavelet_monodepth_tpu_torch.utils.device import pin_float32
        pin_float32(device)
        encoder.load_state_dict(weights["encoder"], strict=True)
        decoder.load_state_dict(weights["decoder"], strict=True)
        self.encoder = encoder.to(device).eval()
        self.decoder = decoder.to(device).eval()
        self.params = params
        self.ratio = None

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, masks: dict | None) -> dict:
        with record_function("encoder"):
            feats = self.encoder(x)
        with record_function("decoder"):
            if masks is None:
                out = self.decoder(feats)
            else:
                out = self.decoder(feats, thresh_ratio=self.ratio,
                                   mask_override=masks,
                                   use_pallas=self.params["backend"])
        res = {"disp": out[("disp", 0)]}
        if masks is not None:
            res["masks"] = {k: v for k, v in out.items()
                            if isinstance(k[0], str)
                            and k[0].endswith("_mask")}
            res["total_ops"] = out[("total_ops", -1)]
        return res
