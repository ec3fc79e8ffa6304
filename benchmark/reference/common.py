"""Building blocks of the plain references (NCHW, float32).

`Precision` says how the convolutions and matmuls run: "f32" in float32
(the configurations' precision: TF32 off for cuBLAS and cuDNN), "tf32" in
TF32, the control, the reference in the nearest precision below the
configuration's. On the card "tf32" turns TF32 on for cuBLAS and cuDNN
(`precision_mode`), forward and backward; on the CPU, which has no TF32,
it rounds both operands of each conv and matmul to TF32's 10-bit
mantissa (nearest even) and lets the gradient pass unrounded.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def to_tf32(t: Tensor) -> Tensor:
    """float32 rounded to TF32 (10 mantissa bits), nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"precision must be f32 or tf32, got {name!r}")
        self.name = name

    def operand(self, t: Tensor) -> Tensor:
        if self.name == "tf32" and t.device.type == "cpu":
            return t + (to_tf32(t) - t).detach()
        return t


@contextlib.contextmanager
def precision_mode(p: Precision):
    """TF32 on for cuBLAS and cuDNN under "tf32", off under "f32", while
    the reference runs (the flags are restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = p.name == "tf32"
    torch.backends.cudnn.allow_tf32 = p.name == "tf32"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def conv(x: Tensor, w: Tensor, b: Tensor | None, p: Precision,
         stride: int = 1, padding: int = 0) -> Tensor:
    return F.conv2d(p.operand(x), p.operand(w), b, stride=stride,
                    padding=padding)


def matmul(a: Tensor, b: Tensor, p: Precision) -> Tensor:
    return torch.matmul(p.operand(a), p.operand(b))


_PAD = {"reflect": "reflect", "replicate": "replicate", "zero": "constant"}


def conv3x3(x: Tensor, w: Tensor, b: Tensor | None, p: Precision,
            pad: str) -> Tensor:
    """Pad by one pixel in `pad` mode, then a VALID 3x3 conv."""
    return conv(F.pad(x, (1, 1, 1, 1), mode=_PAD[pad]), w, b, p)


def bn_spec(spec: list, name: str, c: int) -> None:
    """Append a BatchNorm's state-dict entries [(key, shape, kind)]."""
    spec += [(f"{name}.weight", (c,), "bn_weight"),
             (f"{name}.bias", (c,), "bn_bias"),
             (f"{name}.running_mean", (c,), "bn_mean"),
             (f"{name}.running_var", (c,), "bn_var"),
             (f"{name}.num_batches_tracked", (), "count")]


def sparse3x3_ops(n: Tensor, cin: int, cout: int) -> Tensor:
    """The reference's op counter of one sparse 3x3 conv over n active
    output pixels."""
    return 9.0 * cin * n + (1.0 + 9.0 * cin) * n * cout


def bn_eval(x: Tensor, sd: dict, name: str, eps: float = 1e-5) -> Tensor:
    return F.batch_norm(x, sd[f"{name}.running_mean"],
                        sd[f"{name}.running_var"], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], False, 0.0, eps)


def bn_train(x: Tensor, sd: dict, name: str, eps: float = 1e-5) -> Tensor:
    """Train-mode BatchNorm: the batch's statistics (biased variance)."""
    return F.batch_norm(x, None, None, sd[f"{name}.weight"],
                        sd[f"{name}.bias"], True, 0.0, eps)


def up2(x: Tensor) -> Tensor:
    """Nearest-neighbour x2 upsampling."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def dilate(mask: Tensor, k: int) -> Tensor:
    """k x k dilation of a {0, 1} mask, zero outside the image."""
    return F.max_pool2d(F.pad(mask, (k // 2,) * 4), k, stride=1)


def stage_masks(mask: Tensor) -> dict:
    """The sparse decoders' published dilation rule for one scale, from
    its raw mask m (N, 1, h, w): lowres = dilate3(m), upconv0 = dilate5(m)
    at h x w; with u = up2(m): upsample = dilate5(u), upconv1 =
    dilate3(u), wavelet = u at 2h x 2w."""
    u = up2(mask)
    return {"lowres": dilate(mask, 3), "upconv0": dilate(mask, 5),
            "upsample": dilate(u, 5), "upconv1": dilate(u, 3),
            "wavelet": u}


def haar_idwt(ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor) -> Tensor:
    """Single-level orthonormal Haar synthesis, (N, C, H, W) subbands ->
    (N, C, 2H, 2W), (LH, HL, HH) in pytorch_wavelets' order."""
    n, c, h, w = ll.shape
    out = ll.new_empty((n, c, 2 * h, 2 * w))
    out[:, :, 0::2, 0::2] = (ll + lh + hl + hh) * 0.5
    out[:, :, 0::2, 1::2] = (ll + lh - hl - hh) * 0.5
    out[:, :, 1::2, 0::2] = (ll - lh + hl - hh) * 0.5
    out[:, :, 1::2, 1::2] = (ll - lh - hl + hh) * 0.5
    return out


def nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)
