"""Block-granular gather and scatter for the tile-compact sparse engine
(K5, K6).

Counterpart of `wavelet_monodepth_tpu/ops/blockio.py`, with the same
public functions and signatures (less the TPU-only `interpret`):

  wtile_stack    (N, H, W, C) -> (N, nw, nh+1, th, tw + 2*halo, C), the
                 W-halo-tiled stack both kernels index; plain torch
  band_gather    copy the (window_h <= 2*th)-row halo window of each
                 active tile out of two vertically adjacent blocks   (K5)
  block_scatter  write (K, th, tw, C) tiles to their (n, ty, tx) home in
                 a zeros canvas (N, nh*th, nw*tw, C)                 (K6)

Both are pure copies, in float32 or bfloat16 (the JAX kernels take the
data's dtype). On a CUDA tensor they launch the hand-written Hopper
kernels of `csrc/blockio.cu` (the instance of the data's dtype) or
raise; on a CPU tensor they run `band_gather_plain` /
`block_scatter_plain`, which are also what the kernels are checked
against on the card (bitwise: nothing is summed).

block_scatter's idx rows must be distinct and inside the block grid. On
the CPU the wrapper checks and raises; on the card the kernel checks
while it inverts idx, skips the faulty rows and adds them to a per-device
counter, so a call makes no host sync: `scatter_faults(device)` reads it
(that read is the sync).

`launches` counts kernel launches per wrapper, both dtypes;
`launches_bf16` the bfloat16 ones among them. The CPU path never counts.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .image import pad2d

Tensor = torch.Tensor

# kernel launches per wrapper since the last reset_launches()
launches = {"band_gather": 0, "block_scatter": 0}
launches_bf16 = {"band_gather": 0, "block_scatter": 0}

# the kernels' dtypes and the suffix of their C entry points
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


# device index -> the scatter kernel's fault counter, one int32 on the card
_scatter_faults: dict[int, Tensor] = {}
# device index -> the most tiles a scatter's block grid may hold there
_max_tiles: dict[int, int] = {}


def reset_launches() -> None:
    for counts in (launches, launches_bf16):
        for k in counts:
            counts[k] = 0


def wtile_stack(x: Tensor, th: int, tw: int, halo: int,
                pad_mode: str = "reflect") -> Tensor:
    """(N, H, W, C) -> (N, nw, nh+1, th, tw + 2*halo, C): W-halo-tiled, H
    split into th-row blocks so a window of th + 2*halo rows starting at
    any tile row lives in two vertically adjacent blocks.

    The image is padded by `halo` with pad_mode (the oracle's pad2d around
    the true image), then zero-extended to the block grid."""
    n, h, w, c = x.shape
    if th < 2 * halo or tw < 2 * halo:
        raise ValueError("band windows need tile >= 2*halo")
    nh, nw = -(-h // th), -(-w // tw)
    if halo:
        x = pad2d(x, halo, pad_mode)
    x = F.pad(x, (0, 0, 0, nw * tw + 2 * halo - x.shape[2],
                  0, (nh + 1) * th - x.shape[1]))
    cols = torch.stack([x[:, :, j * tw:j * tw + tw + 2 * halo]
                        for j in range(nw)], dim=1)
    return cols.reshape(n, nw, nh + 1, th, tw + 2 * halo, c)


def band_gather_plain(stack: Tensor, idx: Tensor, th: int,
                      window_h: int) -> Tensor:
    """The plain PyTorch version of band_gather: the top block's rows, then
    the block below it, cut to window_h rows."""
    b, ty, tx = (idx[:, j].long() for j in range(3))
    band = torch.cat([stack[b, tx, ty], stack[b, tx, ty + 1]], dim=1)
    return band[:, :window_h].contiguous()


def block_scatter_plain(vals: Tensor, idx: Tensor, n: int, nh: int,
                        nw: int) -> Tensor:
    """The plain PyTorch version of block_scatter."""
    k, th, tw, c = vals.shape
    out = vals.new_zeros((n, nh, nw, th, tw, c))
    b, ty, tx = (idx[:, j].long() for j in range(3))
    out[b, ty, tx] = vals
    return out.permute(0, 1, 3, 2, 4, 5).reshape(n, nh * th, nw * tw, c)


def band_gather(stack: Tensor, idx: Tensor, th: int,
                window_h: int) -> Tensor:
    """Gather halo windows for the active tiles.

    Args:
      stack: (N, nw, nh+1, th, twp, C) from wtile_stack.
      idx: (K, 3) int32 rows (n, ty, tx); ty in [0, nh).
      window_h: rows per window (th + 2*halo), must be <= 2*th.
    Returns (K, window_h, twp, C).
    """
    n, nw, nhp, th_, twp, c = stack.shape
    if th_ != th or window_h > 2 * th:
        raise ValueError(f"band_gather needs the stack's block height "
                         f"{th_} == th {th} and window_h {window_h} <= "
                         f"2*th")
    _check_idx(idx, stack)
    if _on_cpu(stack):
        return band_gather_plain(stack, idx, th, window_h)
    return _launch_gather(stack, idx, window_h)


def block_scatter(vals: Tensor, idx: Tensor, n: int, nh: int,
                  nw: int) -> Tensor:
    """Scatter (K, th, tw, C) tiles to a dense (N, nh*th, nw*tw, C) zeros
    canvas at block positions idx (K, 3) = (n, ty, tx). The idx rows must
    be distinct and inside the (n, nh, nw) grid. On a CPU tensor the
    wrapper raises otherwise; on the card the kernel writes nothing for a
    row outside the grid, keeps the last of the rows naming one tile, and
    counts both in `scatter_faults(device)`, with no host sync."""
    _check_idx(idx, vals)
    if _on_cpu(vals):
        b, ty, tx = (idx[:, j].long() for j in range(3))
        lin = (b * nh + ty) * nw + tx
        ok = bool(((idx >= 0).all() & (b < n).all() & (ty < nh).all()
                   & (tx < nw).all()) if idx.numel() else True)
        if not ok or lin.unique().numel() != lin.numel():
            raise ValueError("block_scatter needs distinct idx rows inside "
                             f"the ({n}, {nh}, {nw}) block grid")
        return block_scatter_plain(vals, idx, n, nh, nw)
    return _launch_scatter(vals, idx, n, nh, nw)


def scatter_faults(device) -> int:
    """The block_scatter kernel's faults on `device` so far: idx rows
    outside the block grid, and rows naming a tile an earlier row named.
    Reading it synchronises with the device; 0 before any launch there."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"scatter_faults counts on a CUDA device, not "
                         f"{device}")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    counter = _scatter_faults.get(index)
    return 0 if counter is None else int(counter.item())


def _check_idx(idx: Tensor, like: Tensor) -> None:
    if idx.dim() != 2 or idx.shape[1] != 3:
        raise ValueError(f"idx must be (K, 3), got {tuple(idx.shape)}")
    if idx.device != like.device:
        raise ValueError(f"idx is on {idx.device}, data on {like.device}")


def _on_cpu(x: Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"block IO runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    return False


# --- the kernels -------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..kernels import build
        lib = build.load("blockio")
        p, i = ctypes.c_void_p, ctypes.c_int
        for suffix in KERNEL_DTYPES.values():
            for name in ("band_gather", "block_scatter"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = ([p] * 3 + [i] * 8 + [p]
                               if name == "band_gather"
                               else [p] * 4 + [i] * 8 + [p])
                fn.restype = i
        lib.block_scatter_max_tiles.argtypes = [i]
        lib.block_scatter_max_tiles.restype = i
        lib.blockio_error_string.argtypes = [i]
        lib.blockio_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_kernel_inputs(data: Tensor, idx: Tensor) -> Tensor:
    if data.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16; got "
                        f"{data.dtype}")
    if not data.is_contiguous():
        raise ValueError("the block IO kernels need contiguous data")
    if data.numel() >= 2 ** 31:
        raise ValueError("block IO kernels index with 32-bit offsets")
    return idx.to(torch.int32).contiguous()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _kernel_lib().blockio_error_string(err).decode())


def _count(name: str, dtype: torch.dtype) -> None:
    launches[name] += 1
    if dtype == torch.bfloat16:
        launches_bf16[name] += 1


def _launch_gather(stack: Tensor, idx: Tensor, window_h: int) -> Tensor:
    idx = _check_kernel_inputs(stack, idx)
    n, nw, nhp, th, twp, c = stack.shape
    k = idx.shape[0]
    out = torch.empty((k, window_h, twp, c), dtype=stack.dtype,
                      device=stack.device)
    if out.numel() == 0:
        return out
    fn = getattr(_kernel_lib(), f"band_gather_{KERNEL_DTYPES[stack.dtype]}")
    stream = torch.cuda.current_stream(stack.device).cuda_stream
    _raise_on(fn(stack.data_ptr(), idx.data_ptr(), out.data_ptr(), k, n, nw,
                 nhp, th, twp * c, window_h, stack.device.index, stream),
              "band_gather")
    _count("band_gather", stack.dtype)
    return out


def _launch_scatter(vals: Tensor, idx: Tensor, n: int, nh: int,
                    nw: int) -> Tensor:
    """The canvas's allocation and the kernel, which writes all of it
    (chip_smoke.py times this)."""
    idx = _check_kernel_inputs(vals, idx)
    k, th, tw, c = vals.shape
    dev = vals.device.index
    out = torch.empty((n, nh * th, nw * tw, c), dtype=vals.dtype,
                      device=vals.device)
    if out.numel() == 0:
        return out
    if out.numel() >= 2 ** 31:
        raise ValueError("block IO kernels index with 32-bit offsets")
    lib = _kernel_lib()
    if dev not in _max_tiles:
        got = lib.block_scatter_max_tiles(dev)
        _raise_on(max(0, -got), "block_scatter_max_tiles")
        _max_tiles[dev] = got
    if n * nh * nw > _max_tiles[dev]:
        raise ValueError(f"block_scatter's ({n}, {nh}, {nw}) block grid "
                         f"needs {4 * n * nh * nw} bytes of shared memory; "
                         f"a block of this card has {4 * _max_tiles[dev]}")
    faults = _scatter_faults.get(dev)
    if faults is None:
        faults = _scatter_faults[dev] = torch.zeros(
            1, dtype=torch.int32, device=vals.device)
    fn = getattr(lib, f"block_scatter_{KERNEL_DTYPES[vals.dtype]}")
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    _raise_on(fn(vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 faults.data_ptr(), k, n, nh, nw, th, tw, c, dev, stream),
              "block_scatter")
    _count("block_scatter", vals.dtype)
    return out
