"""NYUv2 (DenseDepth-lineage) decoders: the dense baseline, the wavelet
decoders and the sparse wavelet decoder.

Counterpart of `wavelet_monodepth_tpu/models/decoders_nyu.py`
(`NYUv2/networks/decoders/densedepth_decoder.py`: Decoder :15-47,
Decoder224 :50-89, DecoderWave :92-148, DecoderWave224 :151-221,
SparseDecoderWave :224-409). Activations are NHWC; the outputs are the
JAX package's tuple-keyed dicts. NYU "disp" outputs are raw linear values
(no sigmoid): depth in the training units, or DepthNorm disparity in
--disparity mode. Submodules carry the reference's names (`conv2`,
`up<k>.convA`, `wave<k>`, `wave1_ll`, `conv3`, `conv5`, each Conv3x3's
`.conv`), so the `decoder.` part of a reference `model.pth` loads with
`strict=True`; a depthwise-separable conv holds `.depthwise` and
`.pointwise`, the JAX package's names.

`NyuDecoderWave` is DecoderWave and SparseDecoderWave in one module:
dense through scale 2, masked-sparse at scales 1 and 0, with the
reference's op counters. The threshold is per image
(`ops/sparse.wavelet_threshold_mask`), so a batched sparse decode equals
N batch-1 runs. `use_pallas` routes as in JAX: the UpBlocks' convA takes
the backend asked for (K1 on "pallas", K4 on "pallas2d",
`ops/capacity.py` on "capacity"), and the wave heads take K1 for any
truthy `use_pallas` (the string "xla" too, as in JAX); depthwise convs
always run masked dense. In
bfloat16 every configuration that would reach K1 or K4 raises, as JAX
cannot lower them there.

JAX's documented deviations are kept: `NyuDecoderWave224` divides
("disp", 1) by 2 (the reference's `ll // 2` is an integer-division
bug), and `wave_idxmap` is counted once at scale 1 (the reference counts
it twice). `use_polyphase` (JAX's upsample + conv fold) is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops import sparse as sp
from ..ops.image import upsample_nearest2x
from ..ops.wavelets import haar_idwt
from .layers import Conv3x3, DWConv3x3, leaky_relu_02, sparse_backend

Tensor = torch.Tensor


def _f32(v) -> Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _no_polyphase(use_polyphase: bool) -> None:
    if use_polyphase:
        raise NotImplementedError(
            "use_polyphase is not ported (ROADMAP.md, Queue 1 item 7: "
            "upconv1_polyphase is a TPU-only workaround)")


def _conv3x3(cin: int, cout: int, pad_mode: str, depthwise: bool):
    return (DWConv3x3(cin, cout, pad_mode) if depthwise
            else Conv3x3(cin, cout, pad_mode))


def _idwt(ll: Tensor, h: Tensor) -> Tensor:
    return haar_idwt(ll, h[..., 0:1], h[..., 1:2], h[..., 2:3])


def _log(outputs: dict, s: int, yl: Optional[Tensor], h: Tensor) -> None:
    if yl is not None:
        outputs[("wavelets", s, "LL")] = yl
    outputs[("wavelets", s, "LH")] = h[..., 0:1]
    outputs[("wavelets", s, "HL")] = h[..., 1:2]
    outputs[("wavelets", s, "HH")] = h[..., 2:3]


class UpBlock(nn.Module):
    """UpSampleBlock (`NYUv2/networks/layers.py:57-67`): nearest-x2 ->
    concat skip -> Conv3x3(pad) -> LeakyReLU(0.2), maskable."""

    def __init__(self, in_features: int, features: int,
                 pad_mode: str = "reflect", depthwise: bool = False,
                 use_polyphase: bool = False):
        super().__init__()
        _no_polyphase(use_polyphase)
        self.depthwise = depthwise
        self.convA = _conv3x3(in_features, features, pad_mode, depthwise)

    def forward(self, x: Tensor, skip: Tensor,
                up_out_mask: Optional[Tensor] = None,
                out_mask: Optional[Tensor] = None,
                in_mask: Optional[Tensor] = None, use_pallas=False,
                capacity_ratio: float = 0.5) -> Tensor:
        if in_mask is not None:
            x = x * in_mask
        up = torch.cat([upsample_nearest2x(x), skip], dim=-1)
        if up_out_mask is not None:
            up = up * up_out_mask
        if self.depthwise:
            return self.convA(up, None, out_mask, nonlin=leaky_relu_02)
        return self.convA(up, None, out_mask, nonlin=leaky_relu_02,
                          use_pallas=use_pallas,
                          capacity_ratio=capacity_ratio)


def _up_blocks(num_ch_enc, f: int, n: int, pad_mode: str,
               depthwise: bool, use_polyphase: bool) -> list:
    """up1..up<n>: up<k> upsamples f // 2^(k-1) channels, concatenates
    num_ch_enc[-1-k] and outputs f // 2^k."""
    return [UpBlock(f // 2 ** (k - 1) + num_ch_enc[-1 - k], f // 2 ** k,
                    pad_mode, depthwise, use_polyphase)
            for k in range(1, n + 1)]


class NyuDecoder(nn.Module):
    """DenseDepth baseline (`densedepth_decoder.py:15-47`): conv2 + four
    UpBlocks + 3x3 head; ("disp", 0) at H/2. `NyuDecoder224` adds an x2
    upsample + conv5 stage (full resolution)."""

    full_res = False

    def __init__(self, num_ch_enc: Sequence[int],
                 decoder_width: float = 0.5, is_depthwise: bool = False,
                 use_polyphase: bool = False):
        super().__init__()
        self.num_ch_enc = tuple(num_ch_enc)
        f = int(self.num_ch_enc[-1] * decoder_width)
        self.conv2 = Conv3x3(self.num_ch_enc[-1], f, "zero")
        for k, up in enumerate(_up_blocks(self.num_ch_enc, f, 4, "zero",
                                          is_depthwise, use_polyphase)):
            self.add_module(f"up{k + 1}", up)
        head_in = f // 16
        if self.full_res:
            self.conv5 = _conv3x3(f // 16, f // 32, "zero", is_depthwise)
            head_in = f // 32
        self.conv3 = _conv3x3(head_in, 1, "zero", is_depthwise)

    def forward(self, features: Sequence[Tensor]) -> dict:
        x = self.conv2(features[-1])
        for k in range(1, 5):
            x = getattr(self, f"up{k}")(x, features[-1 - k])
        if self.full_res:
            x = leaky_relu_02(self.conv5(upsample_nearest2x(x)))
        return {("disp", 0): self.conv3(x)}


class NyuDecoder224(NyuDecoder):
    """`Decoder224` (`densedepth_decoder.py:50-89`)."""

    full_res = True


class NyuDecoderWave(nn.Module):
    """DecoderWave + SparseDecoderWave in one module.

    Dense (`thresh_ratio=None`): `densedepth_decoder.py:117-148`.
    Sparse (`thresh_ratio` set): `densedepth_decoder.py:271-409`: dense
    through scale 2, masked-sparse scales 1 and 0, with op counters;
    ("total_ops", -1) is (N,) float32.
    """

    def __init__(self, num_ch_enc: Sequence[int],
                 decoder_width: float = 0.5, dw_waveconv: bool = False,
                 dw_upconv: bool = False, use_polyphase: bool = False):
        super().__init__()
        self.num_ch_enc = tuple(num_ch_enc)
        self.dw_waveconv, self.dw_upconv = dw_waveconv, dw_upconv
        f = self.f = int(self.num_ch_enc[-1] * decoder_width)
        self.conv2 = Conv3x3(self.num_ch_enc[-1], f, "replicate")
        ups = _up_blocks(self.num_ch_enc, f, 3, "reflect", dw_upconv,
                         use_polyphase)
        self.up1 = ups[0]
        self.wave1_ll = Conv3x3(f // 2, 1, "replicate")
        self.wave1 = _conv3x3(f // 2, 3, "zero", dw_waveconv)
        self.up2 = ups[1]
        self.wave2 = _conv3x3(f // 4, 3, "zero", dw_waveconv)
        self.up3 = ups[2]
        self.wave3 = _conv3x3(f // 8, 3, "zero", dw_waveconv)

    def forward(self, features: Sequence[Tensor],
                thresh_ratio: Optional[float] = None, use_pallas=False,
                capacity_ratio: float = 0.5,
                mask_override: Optional[dict] = None) -> dict:
        """capacity_ratio: the "capacity" backend's per-conv capacity
        (JAX's default 0.5; active tiles beyond it are dropped).
        mask_override: {sparse scale s: (N, h, w, 1) raw mask} replaces
        the threshold mask at that scale (dilations and op counts follow
        it), as the KITTI decoder's does, to decode at a chosen density."""
        if thresh_ratio is None:
            return self._dense(features)
        return self._sparse(features, thresh_ratio, use_pallas,
                            capacity_ratio, mask_override)

    def _dense(self, features: Sequence[Tensor]) -> dict:
        outputs = {}
        x_d1 = self.up1(self.conv2(features[-1]), features[-2])
        ll = (2.0 ** 3) * self.wave1_ll(x_d1)
        outputs[("disp", 3)] = ll / (2.0 ** 3)
        h = (2.0 ** 2) * self.wave1(x_d1)
        _log(outputs, 2, ll, h)
        ll = _idwt(ll, h)
        outputs[("disp", 2)] = ll / (2.0 ** 2)

        x_d2 = self.up2(x_d1, features[-3])
        h = 2.0 * self.wave2(x_d2)
        _log(outputs, 1, None, h)
        ll = _idwt(ll, h)
        outputs[("disp", 1)] = ll / 2.0

        x_d3 = self.up3(x_d2, features[-4])
        h = self.wave3(x_d3)
        _log(outputs, 0, None, h)
        outputs[("disp", 0)] = _idwt(ll, h)
        return outputs

    def reaches_kernel(self, use_pallas) -> bool:
        """Whether a sparse forward on this backend launches K1 or K4: the
        convAs on "pallas" / "pallas2d" unless depthwise, the wave heads
        for any truthy use_pallas unless depthwise."""
        backend = sparse_backend(use_pallas)
        return ((backend in ("pallas", "pallas2d") and not self.dw_upconv)
                or (bool(use_pallas) and not self.dw_waveconv))

    def _sparse(self, features: Sequence[Tensor], thresh_ratio,
                use_pallas=False, capacity_ratio: float = 0.5,
                mask_override: Optional[dict] = None) -> dict:
        mask_override = mask_override or {}
        x_m1 = features[-1]
        if x_m1.dtype == torch.bfloat16 and self.reaches_kernel(use_pallas):
            raise NotImplementedError(
                f"use_pallas={use_pallas!r} reaches the tile-sparse conv "
                "kernel, which runs float32 only, as the JAX package's "
                "cannot lower in bfloat16 (ROADMAP.md, Queue 3); bfloat16 "
                "runs the NYU decoder on 'xla'")
        outputs = {}
        total = x_m1.new_zeros((x_m1.shape[0],), dtype=torch.float32)

        total += sp.ops_dense_conv3x3_nyu(x_m1.shape, self.f)
        x_d0 = self.conv2(x_m1)
        x_d1 = self.up1(x_d0, features[-2])
        cat_c = x_d0.shape[-1] + features[-2].shape[-1]
        total += _f32((1 + 9 * cat_c) * x_d1.shape[1] * x_d1.shape[2]
                      * x_d1.shape[3])
        ll = (2.0 ** 3) * self.wave1_ll(x_d1)
        outputs[("disp", 3)] = ll / (2.0 ** 3)
        h = (2.0 ** 2) * self.wave1(x_d1)
        total += _f32((1 + 9 * x_d1.shape[-1]) * x_d1.shape[1]
                      * x_d1.shape[2] * 4)
        outputs[("wavelet_mask", 2)] = torch.ones_like(h[..., 0:1])
        _log(outputs, 2, ll, h)
        ll = _idwt(ll, h)
        total += _f32(ll.shape[1] * ll.shape[2])
        outputs[("disp", 2)] = ll / (2.0 ** 2)

        # sparse scales: (scale, up block, wave conv, skip, 2^s coefficient
        # scale)
        x = x_d1
        # JAX calls the heads with use_pallas=True for any truthy
        # use_pallas (`decoders_nyu.py:295-297`)
        heads_backend = bool(use_pallas)
        for s, up, wave, skip, coeff_pow in (
                (1, self.up2, self.wave2, features[-3], 1),
                (0, self.up3, self.wave3, features[-4], 0)):
            if s in mask_override:
                mask = mask_override[s].to(ll.dtype)
            else:
                mask = sp.wavelet_threshold_mask(ll, h, thresh_ratio)
            total += sp.ops_threshold(mask)
            umask = upsample_nearest2x(mask)
            up_mask = sp.dilate_mask(mask, 5)
            conva_mask = sp.dilate_mask(umask, 5)
            wave_mask = sp.dilate_mask(umask, 3)
            wavelet_mask = umask
            total += sp.ops_dilation(mask)
            for m in (wavelet_mask, conva_mask, wave_mask, up_mask):
                total += sp.ops_mask2idxmap(m)
            outputs[("wavelet_mask", s)] = wavelet_mask

            cat_c = x.shape[-1] + skip.shape[-1]
            x = up(x, skip, in_mask=up_mask, up_out_mask=conva_mask,
                   out_mask=wave_mask, use_pallas=use_pallas,
                   capacity_ratio=capacity_ratio)
            total += sp.ops_sparse_conv3x3(
                sp.mask_count(wave_mask), cat_c, x.shape[-1])
            h = wave(x, None, wavelet_mask, use_pallas=heads_backend)
            total += sp.ops_sparse_conv3x3(
                sp.mask_count(wavelet_mask), x.shape[-1], 3)
            h = (2.0 ** coeff_pow) * h
            _log(outputs, s, None, h)
            ll = _idwt(ll, h)
            total += _f32(ll.shape[1] * ll.shape[2])
            outputs[("disp", s)] = ll / (2.0 ** coeff_pow)

        outputs[("total_ops", -1)] = total
        return outputs


class NyuDecoderWave224(nn.Module):
    """`DecoderWave224` (`densedepth_decoder.py:151-221`): four wavelet
    stages (an extra up4 / wave4), coefficient scales 2^4 .. 2^0."""

    def __init__(self, num_ch_enc: Sequence[int],
                 decoder_width: float = 0.5, dw_waveconv: bool = False,
                 dw_upconv: bool = False, use_polyphase: bool = False):
        super().__init__()
        self.num_ch_enc = tuple(num_ch_enc)
        f = int(self.num_ch_enc[-1] * decoder_width)
        self.conv2 = Conv3x3(self.num_ch_enc[-1], f, "replicate")
        ups = _up_blocks(self.num_ch_enc, f, 4, "reflect", dw_upconv,
                         use_polyphase)
        self.up1 = ups[0]
        self.wave1_ll = Conv3x3(f // 2, 1, "replicate")
        self.wave1 = _conv3x3(f // 2, 3, "zero", dw_waveconv)
        for k in range(2, 5):
            self.add_module(f"up{k}", ups[k - 1])
            self.add_module(f"wave{k}", _conv3x3(f // 2 ** k, 3, "zero",
                                                 dw_waveconv))

    def forward(self, features: Sequence[Tensor]) -> dict:
        outputs = {}
        x = self.up1(self.conv2(features[-1]), features[-2])
        ll = (2.0 ** 4) * self.wave1_ll(x)
        h = (2.0 ** 3) * self.wave1(x)
        _log(outputs, 3, ll, h)
        ll = _idwt(ll, h)
        outputs[("disp", 3)] = ll / (2.0 ** 3)
        for k, s in ((2, 2), (3, 1), (4, 0)):
            x = getattr(self, f"up{k}")(x, features[-1 - k])
            h = (2.0 ** s) * getattr(self, f"wave{k}")(x)
            _log(outputs, s, None, h)
            ll = _idwt(ll, h)
            outputs[("disp", s)] = ll / (2.0 ** s)
        return outputs
