"""Banded stereo warp: the reprojection sampler for row-banded grids (K3).

Counterpart of `wavelet_monodepth_tpu/ops/warp.py`, with the same public
function, `grid_sample_border_banded(img, grid)`: `grid_sample_border`
for grids whose sampled row stays within one row of the output row, as
rectified stereo guarantees. The y coordinate is read per row, at column
0, as in JAX, so its gradient reaches `grid[:, :, 0, 1]` only.

The coordinate chain (normalisation and the border clip) is plain torch,
so the clip's gradient is `padding_mode="border"`'s. It ends in x (N, H, W)
and yr (N, H), pixel coordinates inside the image, which `banded_warp`
samples with: on a CUDA tensor, the hand-written Hopper kernel
`csrc/banded_warp.cu` as a `torch.autograd.Function` whose backward is a
kernel too (gradients for src, x and yr; the source-row pass runs only
when src needs a gradient); on a CPU tensor, `banded_warp_plain`, the
same formula as index gathers, which autograd differentiates. The plain
version is also what the kernel is checked against on the card.

`launches` counts kernel launches per direction; the CPU path never
counts.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

Tensor = torch.Tensor

# kernel launches per direction since the last reset_launches()
launches = {"banded_warp_fwd": 0, "banded_warp_bwd": 0}

_SMEM_LIMIT = 227 * 1024          # a Hopper block's shared memory
_SM_SMEM = 228 * 1024             # an SM's, 1 KB of it reserved per block
_SM_BLOCKS = 8                    # 256-thread blocks per SM
_FWD_STAGE = 8 * 128              # floats per channel of the forward's
                                  # per-warp output buffers


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def banded_coords(grid: Tensor, height: int, width: int):
    """(x (N, H, W), yr (N, H)) pixel coordinates of a normalised grid
    (N, H, W, 2) under align_corners=False, clipped to the image; yr is
    row h's y read at column 0. Float32 whatever the grid's dtype."""
    grid = grid.float()
    x = torch.clamp(((grid[..., 0] + 1.0) * width - 1.0) * 0.5,
                    0.0, width - 1.0)
    yr = torch.clamp(((grid[:, :, 0, 1] + 1.0) * height - 1.0) * 0.5,
                     0.0, height - 1.0)
    return x, yr


def banded_warp_plain(src: Tensor, x: Tensor, yr: Tensor) -> Tensor:
    """The plain PyTorch version: src (N, H, W, C) sampled at x (N, H, W)
    and the per-row yr (N, H), computed in float32 by index gathers.
    Returns src's dtype."""
    n, h, w, c = src.shape
    s = src.float()
    fx = torch.floor(x)
    wx = (x - fx)[..., None]
    x0 = fx.long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y0 = torch.floor(yr)
    wy = (yr - y0)[..., None, None]
    row = torch.arange(h, device=src.device)
    sel = torch.clamp(y0 - (row - 1.0), 0.0, 1.0).long()
    lo = (row - 1 + sel).clamp(0, h - 1)
    hi = (row + sel).clamp(0, h - 1)
    batch = torch.arange(n, device=src.device)[:, None]

    def lerp(rows: Tensor) -> Tensor:            # rows (N, H, W, C)
        a = torch.gather(rows, 2, x0[..., None].expand(-1, -1, -1, c))
        b = torch.gather(rows, 2, x1[..., None].expand(-1, -1, -1, c))
        return (1.0 - wx) * a + wx * b

    out = (1.0 - wy) * lerp(s[batch, lo]) + wy * lerp(s[batch, hi])
    return out.to(src.dtype)


class BandedWarp(torch.autograd.Function):
    """The kernel's forward and backward around the coordinate chain."""

    @staticmethod
    def forward(ctx, src: Tensor, x: Tensor, yr: Tensor) -> Tensor:
        ctx.save_for_backward(src, x, yr)
        return _launch_fwd(src, x, yr)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: Tensor):
        src, x, yr = ctx.saved_tensors
        gsrc, gx, gyr = _launch_bwd(src, x, yr, g.contiguous(),
                                    with_src=ctx.needs_input_grad[0])
        return gsrc, gx, gyr


def banded_warp(src: Tensor, x: Tensor, yr: Tensor) -> Tensor:
    """src sampled at (x, yr): the plain version on the CPU, the kernel on
    CUDA (or raise)."""
    if src.device.type == "cpu":
        return banded_warp_plain(src, x, yr)
    if src.device.type != "cuda":
        raise ValueError(f"the banded warp runs on CPU or CUDA tensors, "
                         f"not {src.device}")
    return BandedWarp.apply(src, x, yr)


def grid_sample_border_banded(img: Tensor, grid: Tensor) -> Tensor:
    """`grid_sample_border` for row-banded grids: img (N, H, W, C), grid
    (N, H, W, 2) normalised (x, y), |y(row) - row| <= 1 px. The output has
    the dtype torch promotes img and grid to."""
    n, h, w, c = img.shape
    if tuple(grid.shape) != (n, h, w, 2):
        raise ValueError(f"the banded warp samples an image onto its own "
                         f"grid: grid {tuple(grid.shape)} for img "
                         f"{tuple(img.shape)}")
    dt = torch.promote_types(img.dtype, grid.dtype)
    x, yr = banded_coords(grid, h, w)
    return banded_warp(img.to(dt).contiguous(), x, yr)


# --- the kernel --------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..kernels import build
        lib = build.load("banded_warp")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.banded_warp_fwd_f32.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.banded_warp_fwd_f32.restype = i
        lib.banded_warp_bwd_f32.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.banded_warp_bwd_f32.restype = i
        lib.banded_warp_error_string.argtypes = [i]
        lib.banded_warp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(src: Tensor, x: Tensor, yr: Tensor, g: Tensor = None):
    n, h, w, c = src.shape
    named = [("src", src), ("x", x), ("yr", yr)] + (
        [("g", g)] if g is not None else [])
    for name, t in named:
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(x.shape) != (n, h, w) or tuple(yr.shape) != (n, h):
        raise ValueError(f"x {tuple(x.shape)} / yr {tuple(yr.shape)} do not "
                         f"match src {tuple(src.shape)}")
    if g is not None and g.shape != src.shape:
        raise ValueError(f"g {tuple(g.shape)} is not {tuple(src.shape)}")
    if n * h >= 2 ** 31:
        raise ValueError("N * H exceeds the grid's 2^31 - 1 blocks")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _kernel_lib().banded_warp_error_string(err)
                           .decode())


def band_rows(src: Tensor) -> int:
    """Output rows per forward block: the fewest whose grid fits the card
    in one wave of resident blocks (blocks per SM bounded by shared
    memory), at most what fits one block (its rows and the two neighbours
    they can sample); raises when not even one row fits."""
    n, h, w, c = src.shape
    stage = _FWD_STAGE * c if c <= 4 else 0

    def smem(rows):                 # csrc/banded_warp.cu: fwd_smem_floats
        return 4 * (-(-(rows + 2) * w * c // 4) * 4 + stage)

    if smem(1) > _SMEM_LIMIT:
        raise ValueError(f"W * C = {w * c} floats: a band of one row and "
                         f"its two neighbours exceeds a block's shared "
                         f"memory")
    sms = torch.cuda.get_device_properties(src.device).multi_processor_count
    rows = 1
    while rows < h and smem(rows + 1) <= _SMEM_LIMIT:
        per_sm = min(_SM_SMEM // (smem(rows) + 1024), _SM_BLOCKS)
        if n * -(-h // rows) <= sms * per_sm:
            break
        rows += 1
    return rows


def _launch_fwd(src: Tensor, x: Tensor, yr: Tensor,
                rows: int = None) -> Tensor:
    """The forward kernel; rows: output rows per block (band_rows by
    default)."""
    x, yr = x.contiguous(), yr.contiguous()
    _check(src, x, yr)
    n, h, w, c = src.shape
    out = torch.empty_like(src)
    if out.numel() == 0:
        return out
    rows = band_rows(src) if rows is None else rows
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    _raise_on(lib.banded_warp_fwd_f32(
        src.data_ptr(), x.data_ptr(), yr.data_ptr(), out.data_ptr(),
        n, h, w, c, rows, src.device.index, stream), "banded_warp_fwd")
    launches["banded_warp_fwd"] += 1
    return out


def _launch_bwd(src: Tensor, x: Tensor, yr: Tensor, g: Tensor,
                with_src: bool):
    _check(src, x, yr, g)
    n, h, w, c = src.shape
    if with_src and w * c * 4 > _SMEM_LIMIT:
        raise ValueError(f"W * C = {w * c} floats exceed a block's shared "
                         f"memory")
    gsrc = torch.empty_like(src) if with_src else None
    gx = torch.empty_like(x)
    gyr = torch.empty_like(yr)
    if g.numel() == 0:
        return (torch.zeros_like(src) if with_src else None), \
            torch.zeros_like(x), torch.zeros_like(yr)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    _raise_on(lib.banded_warp_bwd_f32(
        src.data_ptr(), x.data_ptr(), yr.data_ptr(), g.data_ptr(),
        gsrc.data_ptr() if with_src else None, gx.data_ptr(),
        gyr.data_ptr(), n, h, w, c, src.device.index, stream),
        "banded_warp_bwd")
    launches["banded_warp_bwd"] += 1
    return gsrc, gx, gyr
