"""Pose networks for monocular and mono+stereo training.

Counterpart of `wavelet_monodepth_tpu/models/pose.py:20-64`: the
reference's `PoseDecoder` (`KITTI/networks/decoders/pose_decoder.py:
14-54`: one 1x1 `squeeze` conv shared by every input feature -> two 3x3
convs -> a 1x1 to 6 values per frame -> mean over H, W -> x 0.01) and
`PoseCNN` (`KITTI/networks/pose_cnn.py:13-50`: seven stride-2 convs on
the stacked frames, then the same head). Both return (axisangle,
translation), each (N, frames, 1, 3).

The convs sit in an nn.ModuleList `net` in the reference's order
(PoseDecoder: squeeze, pose 0, pose 1, pose 2 -> `net.0..3`; PoseCNN:
`net.0..6`, then `pose_conv`), so the reference's `pose.pth` loads with
`strict=True`. Takes NHWC features or images; the convs run on NCHW
views.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _pose_head(out: Tensor, frames: int):
    """(N, 6 frames, h, w) -> 0.01 x the spatial mean as (axisangle,
    translation), each (N, frames, 1, 3)."""
    out = 0.01 * out.mean(dim=(2, 3)).reshape(-1, frames, 1, 6)
    return out[..., :3], out[..., 3:]


class PoseDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], num_input_features: int = 1,
                 num_frames_to_predict_for: int = 2, stride: int = 1):
        super().__init__()
        self.num_input_features = num_input_features
        self.num_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1),
            nn.Conv2d(num_input_features * 256, 256, 3, stride, 1),
            nn.Conv2d(256, 256, 3, stride, 1),
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1)])

    def forward(self, input_features: Sequence[Sequence[Tensor]]):
        """input_features: one encoder feature pyramid (NHWC) per input
        feature; only the coarsest map of each is read."""
        squeeze = self.net[0]
        out = torch.cat([F.relu(squeeze(_nchw(f[-1])))
                         for f in input_features], dim=1)
        out = F.relu(self.net[1](out))
        out = F.relu(self.net[2](out))
        return _pose_head(self.net[3](out), self.num_frames)


_POSECNN_SPECS = ((16, 7), (32, 5), (64, 3), (128, 3), (256, 3), (256, 3),
                  (256, 3))


class PoseCNN(nn.Module):
    def __init__(self, num_input_frames: int = 2):
        super().__init__()
        self.num_input_frames = num_input_frames
        convs, cin = [], 3 * num_input_frames
        for cout, k in _POSECNN_SPECS:
            convs.append(nn.Conv2d(cin, cout, k, 2, (k - 1) // 2))
            cin = cout
        self.net = nn.ModuleList(convs)
        self.pose_conv = nn.Conv2d(cin, 6 * (num_input_frames - 1), 1)

    def forward(self, x: Tensor):
        """x: (N, H, W, 3 num_input_frames), the frames stacked."""
        x = _nchw(x)
        for conv in self.net:
            x = F.relu(conv(x))
        return _pose_head(self.pose_conv(x), self.num_input_frames - 1)
