"""One sparse decoder scale fused per (image, tile): the wave stage (K2).

Counterpart of `wavelet_monodepth_tpu/ops/pallas_fused.py`, with the same
public function and signature (less the TPU-only `interpret`):
`fused_wave_stage(x, skip, yl, mask, *12 params, i_scale, ht=8, tw=64)`
-> (yh, yl_new, x1). Weights are HWIO, activations NHWC. Per (ht x tw)
high-res tile it runs

    upconv0 (3x3 + ELU, low res) -> nearest x2 upsample -> upconv1 over
    the upsample and the skip (split weights, no concat; 3x3 + ELU) ->
    pos/neg heads (1x1 + LeakyReLU(0.1), 3x3 + sigmoid) -> masked yh ->
    the Haar IDWT butterfly's four phases

with the stage masks applied as the masked-dense oracle applies them.
A tile whose upconv1 mask window (halo included) is empty writes the
yl-only butterfly, zero yh and zero x1. The JAX package calls it from no
decoder path (only tests/test_pallas_fused.py); neither does the port.

The inputs are padded here in torch, each as JAX pads it: x and skip
reflect-padded by 2 after their input masks, the mask planes zero-padded
to their halos; the tile flags are reduced from the upconv1 plane. On a
CUDA tensor the stage then launches the hand-written Hopper kernel
`csrc/fused_wave_stage.cu` (one block per tile, its four convs as
3xTF32 tensor-core implicit GEMMs, within 1e-4 of float32) or raises;
on a CPU tensor it runs `fused_wave_stage_plain`, the same per-tile
computation in torch, which is also what the kernel is checked against
on the card.
Both write untiled (N, nH*ht, nW*tw, .) canvases; the phase interleave
into yl_new stays in torch, as it is outside the kernel in JAX.

Exact up to f32 summation order: equal to the oracle away from a <= 2 px
ring at the image border (4 px for yl_new), where the oracle pads
intermediate features and the tiles pad their inputs.

`launches` counts kernel launches; the CPU path never counts.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .image import pad2d, upsample_nearest2x
from .sparse import stage_masks
from .tile_sparse_conv import elu, leaky_relu_01, sigmoid

Tensor = torch.Tensor

# kernel launches since the last reset_launches()
launches = {"fused_wave_stage": 0}

_SMEM_LIMIT = 227 * 1024          # a Hopper block's shared memory


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _extend(x: Tensor, h: int, w: int) -> Tensor:
    """Zero-extend the spatial dims of (N, H, W) or (N, H, W, C) to h, w."""
    if x.dim() == 3:
        return F.pad(x, (0, w - x.shape[2], 0, h - x.shape[1]))
    return F.pad(x, (0, 0, 0, w - x.shape[2], 0, h - x.shape[1]))


def _stage_inputs(x, skip, yl, mask, ht: int, tw: int) -> dict:
    """The padded, untiled inputs of every tile, as pallas_fused.py pads
    them (interpret-mode widths), and the int32 tile flags (N, nH, nW)."""
    n, h_l, w_l, _ = x.shape
    hl, wl = ht // 2, tw // 2
    n_h, n_w = -(-h_l // hl), -(-w_l // wl)
    hh, wh = n_h * ht, n_w * tw
    sm = stage_masks(mask)
    mu1 = _extend(F.pad(sm["upconv1"][..., 0], (1, 1, 1, 1)), hh + 2, wh + 2)
    flags = F.max_pool2d(mu1[:, None], (ht + 2, tw + 2), (ht, tw))
    return {
        "x": _extend(pad2d(x * sm["lowres"], 2, "reflect"),
                     n_h * hl + 4, n_w * wl + 4),
        "skip": _extend(pad2d(skip * sm["upsample"], 2, "reflect"),
                        hh + 4, wh + 4),
        "yl": _extend(yl[..., 0], hh, wh),
        "m_u0": _extend(F.pad(sm["upconv0"][..., 0], (1, 1, 1, 1)),
                        n_h * hl + 2, n_w * wl + 2),
        "m_up": _extend(F.pad(sm["upsample"][..., 0], (2, 2, 2, 2)),
                        hh + 4, wh + 4),
        "m_u1": mu1,
        "m_wv": _extend(sm["wavelet"][..., 0], hh, wh),
        "flags": (flags[:, 0] > 0).to(torch.int32),
    }


def _tiles(a: Tensor, n_h: int, n_w: int, th: int, tw: int,
           halo: int) -> Tensor:
    """(N, Hp, Wp, ...) -> (N * n_h * n_w, th + 2*halo, tw + 2*halo, ...)
    windows in tile order."""
    return torch.stack([a[:, i * th:i * th + th + 2 * halo,
                          j * tw:j * tw + tw + 2 * halo]
                        for i in range(n_h) for j in range(n_w)],
                       dim=1).flatten(0, 1)


def _untile(t: Tensor, n: int, n_h: int, n_w: int) -> Tensor:
    """(N * n_h * n_w, th, tw, C) -> (N, n_h*th, n_w*tw, C)."""
    _, th, tw, c = t.shape
    return t.reshape(n, n_h, n_w, th, tw, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n, n_h * th, n_w * tw, c)


def _conv(x: Tensor, w: Tensor) -> Tensor:
    """VALID conv of NHWC x with an HWIO w, no bias."""
    return F.conv2d(x.permute(0, 3, 1, 2),
                    w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def fused_wave_stage_plain(inp: dict, params, i_scale: int, ht: int,
                           tw: int):
    """The plain PyTorch version of the kernel: every tile of `inp`
    (from _stage_inputs) computed in a batch, then the flags applied.
    Returns the canvases yh (N, nH*ht, nW*tw, 3), phases (.., 4) and
    x1 (.., Cd)."""
    (w0, b0, w1, b1, wp1, bp1, wp3, bp3, wn1, bn1, wn3, bn3) = params
    n, n_h, n_w = inp["flags"].shape
    hl, wl = ht // 2, tw // 2
    cd = w0.shape[-1]
    xt = _tiles(inp["x"], n_h, n_w, hl, wl, 2)
    st = _tiles(inp["skip"], n_h, n_w, ht, tw, 2)
    m_u0 = _tiles(inp["m_u0"], n_h, n_w, hl, wl, 1)[..., None]
    m_up = _tiles(inp["m_up"], n_h, n_w, ht, tw, 2)[..., None]
    m_u1 = _tiles(inp["m_u1"], n_h, n_w, ht, tw, 1)[..., None]
    m_wv = _tiles(inp["m_wv"], n_h, n_w, ht, tw, 0)[..., None]
    lf = _tiles(inp["yl"], n_h, n_w, ht, tw, 0)[..., None] * 0.5

    x0 = elu(_conv(xt, w0) + b0) * m_u0              # (T, hl+2, wl+2, Cd)
    u = upsample_nearest2x(x0) * m_up                # (T, ht+4, tw+4, Cd)
    x1 = elu(_conv(u, w1[:, :, :cd]) + _conv(st, w1[:, :, cd:]) + b1) * m_u1
    hp = leaky_relu_01(_conv(x1, wp1) + bp1) * m_u1
    pos = sigmoid(_conv(hp, wp3) + bp3)
    hn = leaky_relu_01(_conv(x1, wn1) + bn1) * m_u1
    neg = sigmoid(_conv(hn, wn3) + bn3)
    yh = (2.0 ** (i_scale - 1)) * (pos - neg) * m_wv    # (T, ht, tw, 3)
    h0, h1, h2 = (yh[..., j:j + 1] * 0.5 for j in range(3))
    ph = torch.cat([lf + h0 + h1 + h2, lf + h0 - h1 - h2,
                    lf - h0 + h1 - h2, lf - h0 - h1 + h2], dim=-1)

    on = inp["flags"].reshape(-1, 1, 1, 1) > 0
    yh = torch.where(on, yh, 0.0)
    ph = torch.where(on, ph, lf)
    x1 = torch.where(on, x1[:, 1:-1, 1:-1], 0.0)
    return tuple(_untile(t, n, n_h, n_w) for t in (yh, ph, x1))


def fused_wave_stage(x: Tensor, skip: Tensor, yl: Tensor, mask: Tensor,
                     w0: Tensor, b0: Tensor, w1: Tensor, b1: Tensor,
                     wp1: Tensor, bp1: Tensor, wp3: Tensor, bp3: Tensor,
                     wn1: Tensor, bn1: Tensor, wn3: Tensor, bn3: Tensor,
                     i_scale: int, ht: int = 8, tw: int = 64):
    """One sparse decoder scale, fused.

    Args:
      x: (N, Hl, Wl, Cx) low-res input (the scale's entry features).
      skip: (N, 2Hl, 2Wl, Cs); yl: (N, 2Hl, 2Wl, 1) current low-pass.
      mask: (N, Hl, Wl, 1) raw threshold mask for this scale.
      w0/b0: upconv0 (3x3 HWIO); w1/b1: upconv1 over concat(up, skip),
      split inside; wp*/wn*: pos/neg waveconv head params (1x1, 3x3).
    Returns (yh (N, 2Hl, 2Wl, 3), yl_new (N, 4Hl, 4Wl, 1),
    x1 (N, 2Hl, 2Wl, Cd)).
    """
    if ht % 2 or tw % 2:
        raise ValueError(f"the tile ({ht}, {tw}) must have even sides")
    params = (w0, b0, w1, b1, wp1, bp1, wp3, bp3, wn1, bn1, wn3, bn3)
    inp = _stage_inputs(x, skip, yl, mask, ht, tw)
    if x.device.type == "cpu":
        canvases = fused_wave_stage_plain(inp, params, i_scale, ht, tw)
    elif x.device.type == "cuda":
        canvases = _launch(inp, params, i_scale, ht, tw)
    else:
        raise ValueError(f"the fused stage runs on CPU or CUDA tensors, "
                         f"not {x.device}")
    return assemble(*canvases, 2 * x.shape[1], 2 * x.shape[2])


def assemble(yh: Tensor, ph: Tensor, x1: Tensor, hh: int, wh: int):
    """The canvases cut to (hh, wh) -> (yh, yl_new, x1), the IDWT phases
    interleaved into (a b / d e) 2x2 blocks of yl_new."""
    n = yh.shape[0]
    yh, ph, x1 = yh[:, :hh, :wh], ph[:, :hh, :wh], x1[:, :hh, :wh]
    top = torch.stack([ph[..., 0], ph[..., 1]], dim=3).reshape(n, hh, 2 * wh)
    bot = torch.stack([ph[..., 2], ph[..., 3]], dim=3).reshape(n, hh, 2 * wh)
    yl_new = torch.stack([top, bot], dim=2).reshape(n, 2 * hh, 2 * wh, 1)
    return yh, yl_new, x1


# --- the kernel --------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..kernels import build
        lib = build.load("fused_wave_stage")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_wave_stage_f32.argtypes = [p] * 24 + [i] * 10 + [p]
        lib.fused_wave_stage_f32.restype = i
        lib.fused_wave_stage_smem_bytes.argtypes = [i] * 3
        lib.fused_wave_stage_smem_bytes.restype = i
        lib.fused_wave_stage_error_string.argtypes = [i]
        lib.fused_wave_stage_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def scratch_floats(n_tiles: int, ht: int, tw: int, cd: int) -> int:
    """Global scratch of one launch: each block keeps its x1 and the two
    heads' 1x1 outputs, (ht+2) x (tw+2) x 3Cd floats."""
    return n_tiles * (ht + 2) * (tw + 2) * 3 * cd


def _launch(inp: dict, params, i_scale: int, ht: int, tw: int):
    n, n_h, n_w = inp["flags"].shape
    cx, cs, cd = inp["x"].shape[-1], inp["skip"].shape[-1], params[0].shape[-1]
    named = list(inp.items()) + list(zip(
        ("w0", "b0", "w1", "b1", "wp1", "bp1", "wp3", "bp3", "wn1", "bn1",
         "wn3", "bn3"), params))
    tensors = {}
    for name, t in named:
        if t.device != inp["x"].device:
            raise ValueError(f"{name} is on {t.device}, x on "
                             f"{inp['x'].device}")
        want = torch.int32 if name == "flags" else torch.float32
        if t.dtype != want:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        tensors[name] = t
    shapes = {"w0": (3, 3, cx, cd), "w1": (3, 3, cd + cs, cd),
              "wp1": (1, 1, cd, cd), "wn1": (1, 1, cd, cd),
              "wp3": (3, 3, cd, 3), "wn3": (3, 3, cd, 3)}
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} {tuple(tensors[name].shape)} is not "
                             f"{shape} (weights are HWIO)")
    if cd % 4:
        raise ValueError(f"the kernel takes Cd in multiples of 4, got {cd}")
    lib = _kernel_lib()
    smem = lib.fused_wave_stage_smem_bytes(ht, tw, cd)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"the kernel's shared memory at tile ({ht}, {tw}) "
                         f"and Cd={cd}, {smem} bytes, exceeds a block's")
    n_tiles = n * n_h * n_w
    if n_h * n_w > 2 ** 31 - 1 or n > 65535:
        raise ValueError("the grid is (tiles, N) with N <= 65535")
    dev = inp["x"].device
    hh, wh = n_h * ht, n_w * tw
    yh = torch.empty((n, hh, wh, 3), dtype=torch.float32, device=dev)
    ph = torch.empty((n, hh, wh, 4), dtype=torch.float32, device=dev)
    x1 = torch.empty((n, hh, wh, cd), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_floats(n_tiles, ht, tw, cd),
                          dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return yh, ph, x1
    t = tensors
    err = lib.fused_wave_stage_f32(
        *(t[k].data_ptr() for k in ("x", "skip", "yl", "m_u0", "m_up",
                                    "m_u1", "m_wv", "flags", "w0", "b0",
                                    "w1", "b1", "wp1", "bp1", "wp3", "bp3",
                                    "wn1", "bn1", "wn3", "bn3")),
        yh.data_ptr(), ph.data_ptr(), x1.data_ptr(), scratch.data_ptr(),
        n, n_h, n_w, cx, cs, cd, ht, tw, i_scale, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_wave_stage launch failed: "
                           + lib.fused_wave_stage_error_string(err).decode())
    launches["fused_wave_stage"] += 1
    return yh, ph, x1
