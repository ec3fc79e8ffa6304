"""Depth/disparity conversions and projective geometry.

Counterpart of `wavelet_monodepth_tpu/ops/geometry.py`, function for
function: stateless, NHWC depth maps, (N, 4, 4) intrinsics and poses, and
the normalised (x, y) sample grid the warps take.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def disp_to_depth(disp: Tensor, min_depth: float, max_depth: float):
    """Sigmoid output -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def depth_to_disp(depth: Tensor, min_depth: float, max_depth: float) -> Tensor:
    """Depth map -> normalised disparity, 0 where depth <= 0."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    disp = 1.0 / (depth + 1e-5)
    disp = (disp - min_disp) / (max_disp - min_disp)
    disp = torch.where(depth <= 0, torch.zeros_like(disp), disp)
    return torch.where(disp <= 0, torch.zeros_like(disp), disp)


def rot_from_axisangle(vec: Tensor) -> Tensor:
    """Axis-angle (B, 1, 3) -> 4x4 rotation matrices (B, 4, 4), Rodrigues."""
    angle = torch.linalg.norm(vec, dim=2, keepdim=True)          # (B,1,1)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[:, 0, 0]
    sa = torch.sin(angle)[:, 0, 0]
    c = 1.0 - ca
    x, y, z = axis[:, 0, 0], axis[:, 0, 1], axis[:, 0, 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xc, yc, zc = x * c, y * c, z * c
    xyc, yzc, zxc = x * yc, y * zc, z * xc
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows = [[x * xc + ca, xyc - zs, zxc + ys, zero],
            [xyc + zs, y * yc + ca, yzc - xs, zero],
            [zxc - ys, yzc + xs, z * zc + ca, zero],
            [zero, zero, zero, one]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=1)


def get_translation_matrix(t: Tensor) -> Tensor:
    """Translation (B, 3) or (B, 1, 3) -> 4x4."""
    t = t.reshape(-1, 3)
    eye = torch.eye(4, dtype=t.dtype, device=t.device)
    top = torch.cat([eye[:3, :3].expand(t.shape[0], 3, 3), t[:, :, None]],
                    dim=2)
    return torch.cat([top, eye[3:].expand(t.shape[0], 1, 4)], dim=1)


def transformation_from_parameters(axisangle: Tensor, translation: Tensor,
                                   invert: bool = False) -> Tensor:
    """(axisangle, translation), each (B, 1, 3) -> 4x4 pose."""
    r = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        r = r.transpose(1, 2)
        t = -t
    m = get_translation_matrix(t)
    return torch.matmul(r, m) if invert else torch.matmul(m, r)


def backproject_depth(depth: Tensor, inv_k: Tensor) -> Tensor:
    """Depth (N, H, W, 1) and inv_K (N, 4, 4) -> homogeneous camera points
    (N, 4, H*W), in the promoted dtype of the two.

    The pixel grid is built in depth's dtype, as JAX builds it. Under
    bfloat16 mixed precision depth is bfloat16, and so is the grid: from
    x = 256 up, bfloat16 holds only every second integer (every fourth
    from 512), so columns are off by up to 2 px at 640 wide. The port
    reproduces that fault of the reference (ROADMAP.md, Queue 3)."""
    n, h, w, _ = depth.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device),
        indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(h * w, dtype=depth.dtype,
                                  device=depth.device)])        # (3, HW)
    dt = torch.promote_types(inv_k.dtype, depth.dtype)
    cam = torch.matmul(inv_k[:, :3, :3].to(dt), pix.to(dt))
    cam = depth.reshape(n, 1, h * w) * cam
    return torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)


def project_3d(points: Tensor, k: Tensor, t: Tensor, height: int,
               width: int, eps: float = 1e-7) -> Tensor:
    """Camera points (N, 4, HW) -> normalised sample grid (N, H, W, 2) in
    [-1, 1], last dim (x, y). The products run in the promoted dtype of
    their operands, as jnp.matmul promotes (a bfloat16 pose under mixed
    precision meets float32 intrinsics)."""
    n = points.shape[0]
    dt = torch.promote_types(k.dtype, t.dtype)
    p = torch.matmul(k.to(dt), t.to(dt))[:, :3, :]
    dt = torch.promote_types(p.dtype, points.dtype)
    cam = torch.matmul(p.to(dt), points.to(dt))   # (N, 3, HW)
    pix = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    pix = pix.reshape(n, 2, height, width).permute(0, 2, 3, 1)
    sx = pix[..., 0] / (width - 1)
    sy = pix[..., 1] / (height - 1)
    return torch.stack([(sx - 0.5) * 2.0, (sy - 0.5) * 2.0], dim=-1)
