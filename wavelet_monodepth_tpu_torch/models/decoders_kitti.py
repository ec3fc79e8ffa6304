"""KITTI wavelet decoder, dense and sparse (threshold-gated) in one module.

Counterpart of `KittiWaveletDecoder` in
`wavelet_monodepth_tpu/models/decoders_kitti.py:85-431`. Dense and sparse
share one set of weights, held in `decoder`, an nn.ModuleList in the
reference's order, so a reference `depth.pth` loads with `strict=True`:
for i = 4..1: upconv_i_0, upconv_i_1, (waveconv_4_ll at i == 4),
waveconv_i_pos, waveconv_i_neg.

Output contract (NHWC), the JAX package's tuple keys:
  ("disp", s)                       s in 0..3, disparity in [0, 1]
  ("wavelets", s, "LL"/"LH"/"HL"/"HH")
  ("wavelet_mask", s), ("lowres_mask", s), ...   sparse mode only
  ("total_ops", s), ("total_ops", -1)            sparse mode only, (N,)

`use_pallas` picks the sparse backend: False/"xla" masked dense (cuDNN,
the oracle), True/"pallas" and "pallas2d" the tile-sparse CUDA kernel,
launched 4 times per sparse scale (upconv_i_0, upconv_i_1, the pos and
neg heads' 3x3); "capacity" per-conv top-K tile compaction
(`ops/capacity.py`); "compact" whole-stage tile compaction
(`ops/compact.py`, whose gathers and scatters are the block IO kernels,
6 + 2 launches per sparse scale) and "sites" whole-stage site compaction
(`ops/sites.py`). `compact_cap` is the capacity ratio of the three
compacted backends; their dropped tiles or sites are ("overflow", s).
`use_polyphase` is not ported. In bfloat16 (a fully cast model, as
`tools/infer.py --bfloat16` builds it) every backend but "pallas" and
"pallas2d" runs, as in JAX; those two raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import sparse as sp
from ..ops.capacity import conv_capacity_overflow
from ..ops.compact import (compact_wave_stage, default_tile_shape,
                           stage_capacity_overflow)
from ..ops.convops import conv1x1, conv3x3
from ..ops.sites import site_wave_stage, stage_site_overflow
from ..ops.wavelets import haar_idwt
from .layers import (ConvBlock, WaveConv, check_backend_dtype,
                     sparse_backend, upsample_concat)

Tensor = torch.Tensor

NUM_CH_DEC = (16, 32, 64, 128, 256)


def _idwt(yl: Tensor, yh: Tensor) -> Tensor:
    return haar_idwt(yl, yh[..., 0:1], yh[..., 1:2], yh[..., 2:3])


class KittiWaveletDecoder(nn.Module):
    """DepthWaveProgressiveDecoder and its sparse twin in one module."""

    def __init__(self, num_ch_enc: Sequence[int],
                 use_polyphase: bool = False):
        super().__init__()
        if use_polyphase:
            raise NotImplementedError(
                "use_polyphase is not ported (ROADMAP.md, Queue 1 item 7: "
                "upconv1_polyphase is a TPU-only workaround)")
        self.num_ch_enc = tuple(num_ch_enc)
        blocks = {}
        cin = self.num_ch_enc[-1]
        for i in range(4, 0, -1):
            blocks[f"upconv_{i}_0"] = ConvBlock(cin, NUM_CH_DEC[i])
            blocks[f"upconv_{i}_1"] = ConvBlock(
                NUM_CH_DEC[i] + self.num_ch_enc[i - 1], NUM_CH_DEC[i])
            if i == 4:
                blocks["waveconv_4_ll"] = WaveConv(
                    NUM_CH_DEC[4], NUM_CH_DEC[4] // 4, 1)
            blocks[f"waveconv_{i}_pos"] = WaveConv(
                NUM_CH_DEC[i], NUM_CH_DEC[i], 3)
            blocks[f"waveconv_{i}_neg"] = WaveConv(
                NUM_CH_DEC[i], NUM_CH_DEC[i], 3)
            cin = NUM_CH_DEC[i]
        self.decoder = nn.ModuleList(blocks.values())
        self.blocks = dict(blocks)      # by name; registered via `decoder`

    def forward(self, features: Sequence[Tensor],
                thresh_ratio: Optional[float] = None,
                sparse_scales: Sequence[int] = (1, 2, 3),
                use_pallas=False, compact_cap: float = 0.5,
                mask_override: Optional[dict] = None) -> dict:
        """compact_cap: the capacity ratio of the "compact" (per stage),
        "sites" (per stage, scaled per site set) and "capacity" (per conv)
        backends; active tiles or sites beyond it are dropped.
        mask_override: {scale i: (N, Hl, Wl, 1) raw mask} replaces the
        threshold mask at those scales (dilations still run)."""
        if thresh_ratio is None:
            return self._dense(features)
        return self._sparse(features, thresh_ratio, tuple(sparse_scales),
                            use_pallas, compact_cap, mask_override)

    def _coefficients(self, x: Tensor, i: int, want_ll: bool,
                      in_mask: Optional[Tensor] = None,
                      out_mask: Optional[Tensor] = None,
                      backend: str = "xla", capacity_ratio: float = 0.5):
        """(LL, HF) heads at scale i: yl = 2^i * sigmoid(ll-head),
        yh = 2^(i-1) * (sigmoid(pos) - sigmoid(neg))."""
        yl = None
        if want_ll:
            yl = (2.0 ** i) * self.blocks["waveconv_4_ll"](
                x, in_mask, out_mask)
        if backend in ("xla", "compact", "sites"):
            yh = (2.0 ** (i - 1)) * self._paired_heads(x, i, in_mask,
                                                       out_mask)
            return yl, yh
        pos = self.blocks[f"waveconv_{i}_pos"](
            x, in_mask, out_mask, use_pallas=backend,
            capacity_ratio=capacity_ratio)
        neg = self.blocks[f"waveconv_{i}_neg"](
            x, in_mask, out_mask, use_pallas=backend,
            capacity_ratio=capacity_ratio)
        return yl, (2.0 ** (i - 1)) * (pos - neg)

    def stage_params(self, i: int) -> tuple:
        """Scale i's 12 parameters in the compacted stages' order and JAX
        layout: upconv_i_0 and upconv_i_1 (HWIO weight, bias), then the pos
        and neg heads (1x1 HWIO, bias, 3x3 HWIO, bias). The HWIO copies
        are cached on the layers."""
        c0 = self.blocks[f"upconv_{i}_0"].conv
        c1 = self.blocks[f"upconv_{i}_1"].conv
        params = [c0.hwio_weight(), c0.conv.bias, c1.hwio_weight(),
                  c1.conv.bias]
        for head in ("pos", "neg"):
            wave = self.blocks[f"waveconv_{i}_{head}"]
            params += [wave[0].hwio_weight(), wave[0].conv.bias,
                       wave[2].hwio_weight(), wave[2].conv.bias]
        return tuple(p.detach() for p in params)

    def _compact_stage(self, x: Tensor, skip: Tensor, mask: Tensor, i: int,
                       cap_ratio: float, backend: str):
        """Whole-stage compacted execution of scale i: "compact" = tile
        granularity (ops/compact.py), "sites" = pixel granularity
        (ops/sites.py). Returns (yh, x1, overflow)."""
        params = self.stage_params(i)
        if backend == "sites":
            caps = {"cap_hi": min(1.0, 2 * cap_ratio),
                    "cap_lo": min(1.0, 2.8 * cap_ratio),
                    "cap_wav": min(1.0, 1.4 * cap_ratio)}
            yh, x1 = site_wave_stage(x, skip, mask, *params, i_scale=i,
                                     **caps)
            return yh, x1, stage_site_overflow(mask, **caps)
        th, tw = default_tile_shape(2 * x.shape[1], 2 * x.shape[2])
        yh, x1 = compact_wave_stage(x, skip, mask, *params, i_scale=i,
                                    th=th, tw=tw, cap_ratio=cap_ratio)
        return yh, x1, stage_capacity_overflow(mask, th, tw, cap_ratio)

    def _paired_heads(self, x: Tensor, i: int,
                      in_mask: Optional[Tensor] = None,
                      out_mask: Optional[Tensor] = None) -> Tensor:
        """sigmoid(pos(x)) - sigmoid(neg(x)) with both heads fused into one
        1x1 (C -> 2M) + leaky + block-diagonal 3x3 (2M -> 6), as the JAX
        package's xla path runs them; the zero blocks add exact zeros."""
        pos = self.blocks[f"waveconv_{i}_pos"]
        neg = self.blocks[f"waveconv_{i}_neg"]
        w1 = torch.cat([pos[0].conv.weight, neg[0].conv.weight])
        b1 = torch.cat([pos[0].conv.bias, neg[0].conv.bias])
        if in_mask is not None:
            x = x * in_mask
        h = F.leaky_relu(conv1x1(x, w1, b1), negative_slope=0.1)
        if in_mask is not None:
            h = h * in_mask
        wp, wn = pos[2].conv.weight, neg[2].conv.weight
        m = wp.shape[1]
        w3 = wp.new_zeros((6, 2 * m, 3, 3))
        w3[:3, :m] = wp
        w3[3:, m:] = wn
        b3 = torch.cat([pos[2].conv.bias, neg[2].conv.bias])
        y = torch.sigmoid(conv3x3(h, w3, b3, "reflect"))
        yh = y[..., :3] - y[..., 3:]
        if out_mask is not None:
            yh = yh * out_mask
        return yh

    @staticmethod
    def _log_coeffs(outputs: dict, s: int, yl: Tensor, yh: Tensor):
        outputs[("wavelets", s, "LL")] = yl
        outputs[("wavelets", s, "LH")] = yh[..., 0:1]
        outputs[("wavelets", s, "HL")] = yh[..., 1:2]
        outputs[("wavelets", s, "HH")] = yh[..., 2:3]

    def _dense(self, features: Sequence[Tensor]) -> dict:
        outputs = {}
        x = features[-1]
        yl = None
        for i in range(4, 0, -1):
            x = self.blocks[f"upconv_{i}_0"](x)
            x = self.blocks[f"upconv_{i}_1"](
                upsample_concat(x, features[i - 1]))
            new_yl, yh = self._coefficients(x, i, want_ll=(i == 4))
            if i == 4:
                yl = new_yl
            self._log_coeffs(outputs, i - 1, yl, yh)
            yl = _idwt(yl, yh)
            outputs[("disp", i - 1)] = torch.clamp(yl / (2.0 ** (i - 1)),
                                                   0, 1)
        return outputs

    def _sparse(self, features: Sequence[Tensor], thresh_ratio,
                sparse_scales: tuple, use_pallas=False,
                compact_cap: float = 0.5,
                mask_override: Optional[dict] = None) -> dict:
        backend = sparse_backend(use_pallas)
        x = features[-1]
        check_backend_dtype(backend, x.dtype)
        outputs = {}
        yl = yh = None
        # per-image op counts (N,): each image accounts like a reference
        # batch-1 run
        total_ops = x.new_zeros((x.shape[0],), dtype=torch.float32)
        for i in range(4, 0, -1):
            scale_ops = x.new_zeros((x.shape[0],), dtype=torch.float32)
            if i == 4:
                mask = torch.ones_like(x[..., :1])
            elif mask_override is not None and i in mask_override:
                mask = mask_override[i].to(x.dtype)
                scale_ops += sp.ops_threshold(mask)
            else:
                mask = sp.wavelet_threshold_mask(yl, yh, thresh_ratio)
                scale_ops += sp.ops_threshold(mask)
            masks = sp.stage_masks(mask)
            scale_ops += sp.ops_dilation(mask)

            s = i - 1
            outputs[("lowres_mask", s)] = masks["lowres"]
            outputs[("upconv0_mask", s)] = masks["upconv0"]
            outputs[("upsample_mask", s)] = masks["upsample"]
            outputs[("upconv1_mask", s)] = masks["upconv1"]
            outputs[("wavelet_mask", s)] = masks["wavelet"]

            skip = features[i - 1]
            ichn1 = NUM_CH_DEC[i] + skip.shape[-1]
            if i in sparse_scales and i != 4:
                for key in ("lowres", "upconv0", "upsample", "upconv1"):
                    scale_ops += sp.ops_mask2idxmap(masks[key])
                ichn0 = x.shape[-1]
                # tiles or sites dropped past the capacity: 0 = this scale
                # matched the oracle
                if backend in ("compact", "sites"):
                    yh, x, outputs[("overflow", s)] = self._compact_stage(
                        x, skip, mask, i, compact_cap, backend)
                else:
                    if backend == "capacity":
                        outputs[("overflow", s)] = (
                            conv_capacity_overflow(
                                masks["upconv0"], capacity_ratio=compact_cap)
                            + conv_capacity_overflow(
                                masks["upconv1"], capacity_ratio=compact_cap)
                            + 2 * conv_capacity_overflow(
                                masks["wavelet"], capacity_ratio=compact_cap))
                    x = self.blocks[f"upconv_{i}_0"](
                        x, in_mask=masks["lowres"],
                        out_mask=masks["upconv0"], use_pallas=backend,
                        capacity_ratio=compact_cap)
                    x = upsample_concat(x, skip, out_mask=masks["upsample"])
                    x = self.blocks[f"upconv_{i}_1"](
                        x, out_mask=masks["upconv1"], use_pallas=backend,
                        capacity_ratio=compact_cap)
                    _, yh = self._coefficients(
                        x, i, want_ll=False, in_mask=masks["upconv1"],
                        out_mask=masks["wavelet"], backend=backend,
                        capacity_ratio=compact_cap)
                scale_ops += sp.ops_sparse_conv3x3(
                    sp.mask_count(masks["upconv0"]), ichn0, NUM_CH_DEC[i])
                scale_ops += sp.ops_sparse_conv3x3(
                    sp.mask_count(masks["upconv1"]), ichn1, NUM_CH_DEC[i])
                n_in = sp.mask_count(masks["upconv1"])
                n_out = sp.mask_count(masks["wavelet"])
                for _ in range(2):   # pos + neg heads
                    scale_ops += sp.ops_sparse_conv1x1(
                        n_in, NUM_CH_DEC[i], NUM_CH_DEC[i])
                    scale_ops += sp.ops_sparse_conv3x3(
                        n_out, NUM_CH_DEC[i], 3)
            else:
                scale_ops += sp.ops_dense_conv3x3(x.shape, NUM_CH_DEC[i])
                x = self.blocks[f"upconv_{i}_0"](x)
                ux_shape = (x.shape[0], 2 * x.shape[1], 2 * x.shape[2],
                            ichn1)
                scale_ops += sp.ops_dense_conv3x3(ux_shape, NUM_CH_DEC[i])
                x = self.blocks[f"upconv_{i}_1"](upsample_concat(x, skip))
                want_ll = (i == 4)
                new_yl, yh = self._coefficients(x, i, want_ll=want_ll)
                yh = yh * masks["wavelet"]
                if want_ll:
                    yl = new_yl
                    scale_ops += sp.ops_dense_conv1x1(
                        x.shape, NUM_CH_DEC[4], NUM_CH_DEC[4] // 4)
                    scale_ops += sp.ops_dense_conv3x3(
                        x.shape[:3] + (NUM_CH_DEC[4] // 4,), 1)
                for _ in range(2):
                    scale_ops += sp.ops_dense_conv1x1(
                        x.shape, NUM_CH_DEC[i], NUM_CH_DEC[i])
                    scale_ops += sp.ops_dense_conv3x3(x.shape, 3)

            self._log_coeffs(outputs, s, yl, yh)
            yl = _idwt(yl, yh)
            scale_ops += sp.ops_idwt(yl.shape)
            outputs[("disp", s)] = torch.clamp(yl / (2.0 ** s), 0, 1)
            outputs[("total_ops", s)] = scale_ops
            total_ops += scale_ops
        outputs[("total_ops", -1)] = total_ops
        return outputs
