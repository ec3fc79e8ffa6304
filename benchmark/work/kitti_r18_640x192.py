"""Work of `kitti_r18_640x192`: ResNet18 at H x W and the KITTI wavelet
decoder, dense or under raw masks at scales 3, 2, 1 (dilated by the
published rule, `reference.common.stage_masks`)."""

from __future__ import annotations

from .common import active_pixels, conv_flops, sparse_conv_bytes

NUM_CH_ENC = (64, 64, 128, 256, 512)
NUM_CH_DEC = (16, 32, 64, 128, 256)


def encoder_flops(h: int, w: int) -> float:
    """ResNet18 per frame: the 7x7/2 stem, 8 BasicBlocks, 3 downsamples."""
    ho, wo = h // 2, w // 2
    total = conv_flops(3, 64, 7, ho * wo)
    ho, wo = ho // 2, wo // 2                  # max pool
    for stage in range(4):
        cin, cout = NUM_CH_ENC[stage], NUM_CH_ENC[stage + 1]
        if stage > 0:
            ho, wo = ho // 2, wo // 2
            total += conv_flops(cin, cout, 1, ho * wo)       # downsample
        total += conv_flops(cin, cout, 3, ho * wo)
        total += 3 * conv_flops(cout, cout, 3, ho * wo)
    return total


def _scale_convs(i: int, h: int, w: int) -> list:
    """[(cin, cout, k, pixels at lo or hi, mask name)] of decoder scale i
    per frame; the mask name says which dilated mask activates the output
    in a sparse scale."""
    c = NUM_CH_DEC[i]
    cin0 = NUM_CH_ENC[-1] if i == 4 else NUM_CH_DEC[i + 1]
    lo = (h >> (i + 1)) * (w >> (i + 1))
    hi = 4 * lo
    convs = [(cin0, c, 3, lo, "upconv0"),
             (c + NUM_CH_ENC[i - 1], c, 3, hi, "upconv1")]
    if i == 4:
        convs += [(c, c // 4, 1, hi, None), (c // 4, 1, 3, hi, None)]
    convs += 2 * [(c, c, 1, hi, "upconv1"), (c, 3, 3, hi, "wavelet")]
    return convs


def decoder_flops(h: int, w: int, raw_masks: dict | None = None) -> float:
    """Total over the batch of raw_masks (or per frame, dense): dense
    scales count in full, sparse ones only at their masks' active
    pixels."""
    total = 0.0
    for i in range(4, 0, -1):
        counts = None
        if raw_masks is not None and i in raw_masks:
            counts = active_pixels(raw_masks[i])
        for cin, cout, k, px, mask in _scale_convs(i, h, w):
            n = (counts[mask] if counts is not None and mask is not None
                 else px * _frames(raw_masks))
            total += conv_flops(cin, cout, k, n)
    return total


def _frames(raw_masks: dict | None) -> int:
    if raw_masks is None:
        return 1
    return next(iter(raw_masks.values())).shape[0]


def serve_flops(batch: int, h: int, w: int, raw_masks: dict | None) -> float:
    """One request of `batch` frames."""
    dec = decoder_flops(h, w, raw_masks)
    if raw_masks is None:
        dec *= batch
    return batch * encoder_flops(h, w) + dec


def tile_conv_work(h: int, w: int, raw_masks: dict) -> dict:
    """The 3x3 convs the tile-sparse kernel runs in one sparse request (4
    per sparse scale: upconv_i_0, upconv_i_1, the pos and neg heads'
    3x3): operations and bytes, summed."""
    flops = nbytes = 0.0
    for i, raw in raw_masks.items():
        counts = active_pixels(raw)
        n = raw.shape[0]
        for cin, cout, k, px, mask in _scale_convs(i, h, w):
            if k != 3 or mask is None:
                continue
            flops += conv_flops(cin, cout, 3, counts[mask])
            nbytes += sparse_conv_bytes(cin, cout, counts[mask], n * px)
    return {"flops": flops, "bytes": nbytes}


def train_step_flops(batch: int, h: int, w: int) -> float:
    """3 x the dense forward (forward, and backward at twice it), per
    step."""
    return 3.0 * batch * (encoder_flops(h, w) + decoder_flops(h, w))
