"""The work counts against hand counts."""

import numpy as np
import pytest

from benchmark.work import common, kitti_r18_640x192 as kw
from benchmark.work import nyu_densenet161_640x480 as nw


def test_conv_flops_by_hand():
    # ResNet18's 7x7/2 stem at 640x192: 64 filters of 3x7x7 at 320x96
    assert common.conv_flops(3, 64, 7, 320 * 96) == 2 * 3 * 49 * 64 * 30720
    # a depthwise 3x3 over 8 channels: 9 MACs per output value
    assert common.conv_flops(8, 8, 3, 10, groups=8) == 2 * 9 * 8 * 10


def test_resnet18_encoder_by_hand():
    h, w = 192, 640
    stem = 2 * 3 * 49 * 64 * (h // 2) * (w // 2)
    body = 0
    for i, (cin, cout, s) in enumerate(((64, 64, 4), (64, 128, 8),
                                        (128, 256, 16), (256, 512, 32))):
        px = (h // s) * (w // s)
        body += 2 * 9 * (cin * cout + 3 * cout * cout) * px
        if i:
            body += 2 * cin * cout * px
    assert kw.encoder_flops(h, w) == stem + body
    assert kw.encoder_flops(h, w) / 1e9 == pytest.approx(8.88, abs=0.01)


def test_sparse_work_counts_the_dilated_masks():
    """One active raw pixel at scale 3 (in a corner) activates 2x2 = 4
    pixels of dilate3 and 3x3 = 9 of dilate5 at low resolution, and at
    twice the resolution 2x2 of the wavelet mask, 3x3 of its dilate3 and
    4x4 of its dilate5."""
    h, w = 64, 128
    raw = {i: np.zeros((1, h >> (i + 1), w >> (i + 1), 1), np.float32)
           for i in (3, 2, 1)}
    raw[3][0, 0, 0, 0] = 1.0
    got = kw.tile_conv_work(h, w, raw)
    c3, c4 = kw.NUM_CH_DEC[3], kw.NUM_CH_DEC[4]
    flops = (2 * 9 * c4 * c3 * 9                       # upconv_3_0: dilate5
             + 2 * 9 * (c3 + kw.NUM_CH_ENC[2]) * c3 * 9  # upconv_3_1: d3(u)
             + 2 * (2 * 9 * c3 * 3 * 4))               # heads: the wavelet
    assert got["flops"] == flops


def test_nyu_densenet161_encoder_matches_the_published_count():
    # torchvision's densenet161 is 7.7 GMACs at 224x224
    g = nw.encoder_flops(224, 224) / 2 / 1e9
    assert 7.0 < g < 8.0


def test_train_step_is_three_dense_forwards():
    one = kw.encoder_flops(192, 640) + kw.decoder_flops(192, 640)
    assert kw.train_step_flops(12, 192, 640) == 3 * 12 * one
