"""Tile-sparse 3x3 convolution: the kernel that turns wavelet-mask
sparsity into skipped work.

Counterpart of `wavelet_monodepth_tpu/ops/pallas_conv.py`, with the same
public functions and signatures (less the TPU-only `interpret` and
`flat_dots`):

  conv3x3_tile_sparse     skips (image, th-row stripe) granules   (K1)
  conv3x3_tile_sparse_2d  skips (image, th x tw tile) granules    (K4)

Both compute `nonlin(conv3x3(pad(x), w) + b) * out_mask` in float32 and
return float32. On a CUDA tensor they launch the hand-written Hopper
kernel `csrc/tile_sparse_conv.cu` (one kernel for both granularities,
3xTF32 on the tensor cores, within 1e-4 of float32) or raise; on a CPU
tensor they run `conv3x3_masked_plain`, the masked-dense oracle of
`ops/sparse.py`, which is also what the kernel is checked against on
the card. The kernel reduces each block's flag granule of the mask
itself; `stripe_flags` / `tile_flags_2d` compute the same flags in torch,
as the JAX package does on the XLA side.

`launches` counts kernel launches per wrapper; the CPU path never counts.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .image import pad2d

Tensor = torch.Tensor

# kernel launches per wrapper since the last reset_launches()
launches = {"conv3x3_tile_sparse": 0, "conv3x3_tile_sparse_2d": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# The Pallas kernel's epilogue functions (pallas_conv.py:44-57), which the
# CUDA kernel reproduces; the decoder maps F.elu / torch.sigmoid onto them.
def elu(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, torch.exp(x) - 1.0)


def sigmoid(x: Tensor) -> Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def leaky_relu_01(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, 0.1 * x)


def leaky_relu_02(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, 0.2 * x)


_NONLIN_CODES = {None: 0, elu: 1, sigmoid: 2, leaky_relu_01: 3,
                 leaky_relu_02: 4}
_PAD_CODES = {"zero": 0, "reflect": 1, "replicate": 2}
_TILE_H, _TILE_W = 8, 64          # the CUDA kernel's block tile


def stripe_flags(out_mask: Tensor, th: int) -> Tensor:
    """Per-image, per-row-stripe any-active flags from an (N, H, W, 1)
    {0,1} mask. Returns int32 (N * nH,)."""
    n, h = out_mask.shape[0], out_mask.shape[1]
    hp = -(-h // th) * th
    m = F.pad(out_mask[..., 0], (0, 0, 0, hp - h))
    m = m.reshape(n, hp // th, th, -1)
    return (m.amax(dim=(2, 3)) > 0).to(torch.int32).reshape(-1)


def tile_flags(out_mask: Tensor, th: int, tw: int) -> Tensor:
    """2-D tile flags of one (H, W, 1) mask. Returns int32 (nT,)."""
    return tile_flags_2d(out_mask[None], th, tw)


def tile_flags_2d(out_mask: Tensor, th: int, tw: int) -> Tensor:
    """Per-image 2-D tile flags from (N, H, W, 1). Returns (N * nT,)."""
    n, h, w = out_mask.shape[0], out_mask.shape[1], out_mask.shape[2]
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    m = F.pad(out_mask[..., 0], (0, wp - w, 0, hp - h))
    m = m.reshape(n, hp // th, th, wp // tw, tw)
    return (m.amax(dim=(2, 4)) > 0).to(torch.int32).reshape(-1)


def conv3x3_masked_plain(x: Tensor, w: Tensor, b: Tensor, out_mask: Tensor,
                         pad_mode: str = "reflect",
                         nonlin: Optional[Callable] = None) -> Tensor:
    """The plain PyTorch version: float32 conv of the padded input, then
    nonlin, then `* out_mask` (x (N, H, W, Cin), w HWIO)."""
    x, w, b = x.float(), w.float(), b.float()
    y = F.conv2d(pad2d(x, 1, pad_mode).permute(0, 3, 1, 2),
                 w.permute(3, 2, 0, 1), b).permute(0, 2, 3, 1)
    if nonlin is not None:
        y = nonlin(y)
    return y * out_mask.float()


def conv3x3_tile_sparse(x: Tensor, w: Tensor, b: Tensor, out_mask: Tensor,
                        pad_mode: str = "reflect",
                        nonlin: Optional[Callable] = None,
                        th: int = 8) -> Tensor:
    """Masked 3x3 conv with row-stripe skipping.

    Args:
      x: (H, W, Cin) or (N, H, W, Cin), already input-masked if the stage
        requires it. w: (3, 3, Cin, Cout) HWIO. b: (Cout,).
      out_mask: matching (H, W, 1) / (N, H, W, 1) {0,1} float.
      nonlin: None or one of this module's elu / sigmoid / leaky_relu_01 /
        leaky_relu_02 (any callable on the CPU path).
    Returns float32 `nonlin(conv3x3(pad(x), w) + b) * out_mask`.
    """
    squeeze = x.dim() == 3
    if squeeze:
        x, out_mask = x[None], out_mask[None]
    if _on_cpu(x):
        out = conv3x3_masked_plain(x, w, b, out_mask, pad_mode, nonlin)
    else:
        out = _launch("conv3x3_tile_sparse", x, w, b, out_mask, pad_mode,
                      nonlin, gth=th, gtw=x.shape[2])
    return out[0] if squeeze else out


def conv3x3_tile_sparse_2d(x: Tensor, w: Tensor, b: Tensor, out_mask: Tensor,
                           pad_mode: str = "reflect",
                           nonlin: Optional[Callable] = None,
                           th: int = 8, tw: int = 64) -> Tensor:
    """Masked 3x3 conv with 2-D (th x tw) tile skipping. Same contract as
    conv3x3_tile_sparse."""
    squeeze = x.dim() == 3
    if squeeze:
        x, out_mask = x[None], out_mask[None]
    if _on_cpu(x):
        out = conv3x3_masked_plain(x, w, b, out_mask, pad_mode, nonlin)
    else:
        out = _launch("conv3x3_tile_sparse_2d", x, w, b, out_mask, pad_mode,
                      nonlin, gth=th, gtw=tw)
    return out[0] if squeeze else out


def _on_cpu(x: Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"tile-sparse conv runs on CPU or CUDA tensors, "
                         f"not {x.device}")
    return False


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..kernels import build
        lib = build.load("tile_sparse_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tile_sparse_conv3x3_f32.argtypes = [p] * 5 + [i] * 10 + [p]
        lib.tile_sparse_conv3x3_f32.restype = i
        lib.tile_sparse_conv_error_string.argtypes = [i]
        lib.tile_sparse_conv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(key: str, x: Tensor, w: Tensor, b: Tensor, out_mask: Tensor,
            pad_mode: str, nonlin, gth: int, gtw: int) -> Tensor:
    """One kernel launch; each block lies in one (gth, gtw) flag granule
    of out_mask and skips it when no pixel there is > 0."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if nonlin not in _NONLIN_CODES:
        raise ValueError(f"the CUDA kernel's epilogue is one of None, elu, "
                         f"sigmoid, leaky_relu_01, leaky_relu_02 of "
                         f"{__name__}; got {nonlin!r}")
    if pad_mode not in _PAD_CODES:
        raise ValueError(f"pad_mode {pad_mode!r} not in {list(_PAD_CODES)}")
    for name, t in (("x", x), ("w", w), ("b", b), ("out_mask", out_mask)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x NHWC, w HWIO)")
    if tuple(w.shape) != (3, 3, cin, cout) or tuple(b.shape) != (cout,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not "
                         f"match Cin={cin} (w must be HWIO)")
    if tuple(out_mask.shape) != (n, h, wd, 1):
        raise ValueError(f"out_mask {tuple(out_mask.shape)} is not "
                         f"{(n, h, wd, 1)}")
    if pad_mode == "reflect" and min(h, wd) < 2:
        raise ValueError("reflect padding needs H, W >= 2")
    if gth % _TILE_H or (gtw < wd and gtw % _TILE_W):
        raise ValueError(f"flag granule ({gth}, {gtw}) must be a multiple "
                         f"of the kernel's ({_TILE_H}, {_TILE_W}) tile")
    out = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tile_sparse_conv3x3_f32(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out_mask.data_ptr(),
        out.data_ptr(), n, h, wd, cin, cout, _PAD_CODES[pad_mode],
        _NONLIN_CODES[nonlin], gth, gtw, x.device.index, stream)
    if err != 0:
        raise RuntimeError("tile_sparse_conv3x3 launch failed: "
                           + lib.tile_sparse_conv_error_string(err).decode())
    launches[key] += 1
    return out
