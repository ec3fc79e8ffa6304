"""Decoder building blocks: Conv3x3, Conv1x1, ConvBlock, WaveConv,
upsample_concat and NYU's DWConv3x3.

Counterpart of `wavelet_monodepth_tpu/models/layers.py:42-164` (and of
`DWConv3x3` in `models/decoders_nyu.py:41-72`), with the
same `in_mask` / `out_mask` / `use_pallas` routing. Activations are NHWC.
Submodule names reproduce the reference's state-dict keys (ConvBlock ->
`.conv.conv`, WaveConv -> `Sequential(.0.conv, LeakyReLU, .2.conv)`), so
reference checkpoints load with `strict=True`.

`use_pallas` selects the sparse backend when an out_mask is present:
False/"xla" = masked dense (the oracle, cuDNN), True/"pallas" = the
row-stripe tile-skip kernel, "pallas2d" = the 2-D tile-skip kernel (both
`ops/tile_sparse_conv.py`), "capacity" = per-conv top-K tile compaction
(`ops/capacity.py`, `capacity_ratio`). "compact" and "sites" are
whole-stage backends of the decoder (`models/decoders_kitti.py`); a layer
given one of them with an out_mask takes the row-stripe kernel, as the
JAX package's layers do.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import capacity as cap
from ..ops import convops
from ..ops import tile_sparse_conv as tsc
from ..ops.image import pad2d, upsample_nearest2x

Tensor = torch.Tensor


def leaky_relu_02(x: Tensor) -> Tensor:
    """LeakyReLU(0.2), the NYU UpBlock's activation."""
    return F.leaky_relu(x, negative_slope=0.2)


# what the kernels run for each activation the decoders pass (their
# epilogue codes; the values are equal)
_KERNEL_NONLIN = {F.elu: tsc.elu, torch.sigmoid: tsc.sigmoid,
                  leaky_relu_02: tsc.leaky_relu_02}


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draws every conv of `module` from `generator` with the JAX
    package's fan-in init (`models/layers.py:26-39`: weights
    U(+-sqrt(3 / fan_in)), biases U(+-1 / sqrt(fan_in))); BN layers get
    unit scale, zero shift and unit running variance. Draws on the CPU,
    then copies to the module's device, so a seed gives the same weights
    everywhere."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            for p, bound in ((m.weight, (3.0 / fan_in) ** 0.5),
                             (m.bias, fan_in ** -0.5)):
                if p is not None:
                    p.copy_(torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module


BACKENDS = ("xla", "pallas", "pallas2d", "capacity", "compact", "sites")


def sparse_backend(use_pallas) -> str:
    """Normalise `use_pallas` to one of BACKENDS."""
    backend = use_pallas if isinstance(use_pallas, str) else (
        "pallas" if use_pallas else "xla")
    if backend not in BACKENDS:
        raise ValueError(f"unknown sparse backend use_pallas={use_pallas!r}")
    return backend


def check_backend_dtype(use_pallas, dtype: torch.dtype) -> None:
    """Raise where JAX cannot run the backend in `dtype`: its tile-sparse
    conv kernels (K1/K4, "pallas" and "pallas2d") stage into a float32
    scratch and fail to lower in bfloat16; every other backend runs it."""
    backend = sparse_backend(use_pallas)
    if dtype == torch.bfloat16 and backend in ("pallas", "pallas2d"):
        raise NotImplementedError(
            f"use_pallas={backend!r} runs float32 only: its kernel stages "
            "into a float32 scratch, and the JAX package's cannot lower "
            "in bfloat16 (ROADMAP.md, Queue 3). bfloat16 runs on the "
            "'xla', 'compact', 'sites' and 'capacity' backends")


def _hwio(owner: nn.Module, w: Tensor) -> Tensor:
    """`w` (OIHW) as contiguous HWIO, kept on `owner` between calls (a copy
    per call would add a kernel to each) and re-made when the parameter
    changes (load_state_dict bumps its version)."""
    key = (w.data_ptr(), w._version, w.device)
    if owner._hwio is None or owner._hwio[0] != key:
        owner._hwio = (key, w.detach().permute(2, 3, 1, 0).contiguous())
    return owner._hwio[1]


class Conv3x3(nn.Module):
    """Pad-then-conv 3x3; `.conv` holds the reference's nn.Conv2d."""

    def __init__(self, in_features: int, features: int,
                 pad_mode: str = "reflect"):
        super().__init__()
        self.pad_mode = pad_mode
        self.conv = nn.Conv2d(in_features, features, 3)
        self._hwio = None        # (weight version, HWIO copy) for the kernel

    def hwio_weight(self) -> Tensor:
        """The weight as contiguous HWIO (the kernels' and the compacted
        stages' layout), cached."""
        return _hwio(self, self.conv.weight)

    def forward(self, x: Tensor, in_mask: Optional[Tensor] = None,
                out_mask: Optional[Tensor] = None,
                nonlin: Optional[Callable[[Tensor], Tensor]] = None,
                use_pallas=False, capacity_ratio: float = 0.5) -> Tensor:
        if in_mask is not None:
            x = x * in_mask
        backend = sparse_backend(use_pallas)
        if backend == "capacity" and out_mask is not None:
            return cap.conv3x3_capacity_sparse(
                x, self.hwio_weight(), self.conv.bias.detach(), out_mask,
                self.pad_mode, nonlin, capacity_ratio=capacity_ratio)
        if backend != "xla" and out_mask is not None:
            fn = (tsc.conv3x3_tile_sparse_2d if backend == "pallas2d"
                  else tsc.conv3x3_tile_sparse)
            return fn(x.contiguous(), self.hwio_weight(),
                      self.conv.bias.detach(),
                      out_mask.contiguous(), self.pad_mode,
                      _KERNEL_NONLIN.get(nonlin, nonlin))
        y = convops.conv3x3(x, self.conv.weight, self.conv.bias,
                            self.pad_mode)
        if nonlin is not None:
            y = nonlin(y)
        if out_mask is not None:
            y = y * out_mask
        return y


class Conv1x1(nn.Module):
    """Pointwise conv; `.conv` holds the reference's nn.Conv2d."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 1)
        self._hwio = None

    def hwio_weight(self) -> Tensor:
        """The weight as contiguous (1, 1, Cin, Cout) HWIO, cached."""
        return _hwio(self, self.conv.weight)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        y = convops.conv1x1(x, self.conv.weight, self.conv.bias)
        if mask is not None:
            y = y * mask
        return y


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, in_features: int, features: int,
                 pad_mode: str = "reflect"):
        super().__init__()
        self.conv = Conv3x3(in_features, features, pad_mode)

    def forward(self, x: Tensor, in_mask: Optional[Tensor] = None,
                out_mask: Optional[Tensor] = None,
                use_pallas=False, capacity_ratio: float = 0.5) -> Tensor:
        return self.conv(x, in_mask, out_mask, nonlin=F.elu,
                         use_pallas=use_pallas,
                         capacity_ratio=capacity_ratio)


class WaveConv(nn.Sequential):
    """Sequential(Conv1x1, LeakyReLU(0.1), Conv3x3-reflect) coefficient
    head. The intermediate is re-masked under sparsity (see
    ops/sparse.py masked_waveconv)."""

    def __init__(self, in_features: int, mid_features: int,
                 out_features: int):
        super().__init__(Conv1x1(in_features, mid_features),
                         nn.LeakyReLU(0.1),
                         Conv3x3(mid_features, out_features, "reflect"))

    def forward(self, x: Tensor, in_mask: Optional[Tensor] = None,
                out_mask: Optional[Tensor] = None,
                final_nonlin: Optional[Callable[[Tensor], Tensor]]
                = torch.sigmoid, use_pallas=False,
                capacity_ratio: float = 0.5) -> Tensor:
        if in_mask is not None:
            x = x * in_mask
        h = F.leaky_relu(self[0](x), negative_slope=0.1)
        if in_mask is not None:
            h = h * in_mask
        if use_pallas and out_mask is not None:
            return self[2](h, None, out_mask, nonlin=final_nonlin,
                           use_pallas=use_pallas,
                           capacity_ratio=capacity_ratio)
        y = self[2](h)
        if final_nonlin is not None:
            y = final_nonlin(y)
        if out_mask is not None:
            y = y * out_mask
        return y


class DWConv3x3(nn.Module):
    """Depthwise-separable 3x3 (`NYUv2/networks/layers.py:23-25,70-79`):
    pad -> depthwise 3x3 (no bias) -> ReLU -> pointwise 1x1 (no bias).
    `use_pallas` is taken for the interface and ignored: the depthwise
    variant always runs masked dense, as in JAX."""

    def __init__(self, in_features: int, features: int,
                 pad_mode: str = "zero"):
        super().__init__()
        self.pad_mode = pad_mode
        self.depthwise = nn.Conv2d(in_features, in_features, 3,
                                   groups=in_features, bias=False)
        self.pointwise = nn.Conv2d(in_features, features, 1, bias=False)

    def forward(self, x: Tensor, in_mask: Optional[Tensor] = None,
                out_mask: Optional[Tensor] = None,
                nonlin: Optional[Callable[[Tensor], Tensor]] = None,
                use_pallas=False) -> Tensor:
        if in_mask is not None:
            x = x * in_mask
        y = F.relu(convops.conv2d(pad2d(x, 1, self.pad_mode),
                                  self.depthwise.weight,
                                  groups=x.shape[-1]))
        if in_mask is not None:
            y = y * in_mask
        y = convops.conv2d(y, self.pointwise.weight)
        if nonlin is not None:
            y = nonlin(y)
        if out_mask is not None:
            y = y * out_mask
        return y


def upsample_concat(x: Tensor, skip: Optional[Tensor],
                    out_mask: Optional[Tensor] = None) -> Tensor:
    """Nearest-x2 + optional skip concat (+ mask)."""
    y = upsample_nearest2x(x)
    if skip is not None:
        y = torch.cat([y, skip], dim=-1)
    if out_mask is not None:
        y = y * out_mask
    return y
