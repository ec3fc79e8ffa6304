"""Work of `nyu_densenet161_640x480`: DenseNet-161 features at H x W and
the NYU wavelet decoder at decoder_width 0.5, dense or under raw masks at
scales 1 and 0 (dilated by the published rule)."""

from __future__ import annotations

from .common import active_pixels, conv_flops, sparse_conv_bytes

NUM_CH_ENC = (96, 96, 192, 384, 2208)
BLOCK_CONFIG = (6, 12, 36, 24)
GROWTH, BN_SIZE = 48, 4
F_DEC = 1104


def encoder_flops(h: int, w: int) -> float:
    ho, wo = h // 2, w // 2
    total = conv_flops(3, 96, 7, ho * wo)
    ho, wo = ho // 2, wo // 2
    nch = 96
    for bi, nl in enumerate(BLOCK_CONFIG):
        for li in range(nl):
            total += conv_flops(nch + li * GROWTH, BN_SIZE * GROWTH, 1,
                                ho * wo)
            total += conv_flops(BN_SIZE * GROWTH, GROWTH, 3, ho * wo)
        nch += nl * GROWTH
        if bi != len(BLOCK_CONFIG) - 1:
            total += conv_flops(nch, nch // 2, 1, ho * wo)
            nch //= 2
            ho, wo = ho // 2, wo // 2
    return total


def _decoder_convs(h: int, w: int) -> list:
    """[(cin, cout, pixels, sparse scale or None, mask name)] per frame."""
    f, e = F_DEC, NUM_CH_ENC
    p5, p4, p3, p2 = ((h >> k) * (w >> k) for k in (5, 4, 3, 2))
    return [(e[-1], f, p5, None, None),
            (f + e[-2], f // 2, p4, None, None),
            (f // 2, 1, p4, None, None), (f // 2, 3, p4, None, None),
            (f // 2 + e[-3], f // 4, p3, 1, "upconv1"),
            (f // 4, 3, p3, 1, "wavelet"),
            (f // 4 + e[-4], f // 8, p2, 0, "upconv1"),
            (f // 8, 3, p2, 0, "wavelet")]


def serve_flops(batch: int, h: int, w: int, raw_masks: dict | None) -> float:
    counts = ({s: active_pixels(m) for s, m in raw_masks.items()}
              if raw_masks is not None else {})
    total = batch * encoder_flops(h, w)
    for cin, cout, px, s, mask in _decoder_convs(h, w):
        n = counts[s][mask] if s in counts else batch * px
        total += conv_flops(cin, cout, 3, n)
    return total


def tile_conv_work(h: int, w: int, raw_masks: dict) -> dict:
    """The sparse scales' 3x3 convs (K4 for each convA, K1 for each wave
    head on the pallas2d backend)."""
    flops = nbytes = 0.0
    for cin, cout, px, s, mask in _decoder_convs(h, w):
        if s is None or s not in raw_masks:
            continue
        n = raw_masks[s].shape[0]
        active = active_pixels(raw_masks[s])[mask]
        flops += conv_flops(cin, cout, 3, active)
        nbytes += sparse_conv_bytes(cin, cout, active, n * px)
    return {"flops": flops, "bytes": nbytes}
