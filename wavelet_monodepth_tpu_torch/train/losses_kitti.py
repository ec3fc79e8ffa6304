"""KITTI self-supervised losses: photometric reprojection with min-fusion
and automasking, the depth-hint proxy loss, edge-aware smoothness.

Counterpart of `wavelet_monodepth_tpu/train/losses_kitti.py`
(`KITTI/trainer.py:329-646`), NHWC, the same functions and keys, and its
one deliberate fix: `compute_losses_mdp` adds the reprojection term to
the total (the reference drops it).

The "s"-frame and depth-hint warps take the banded warp
(`ops/warp.py`, the K3 kernel on the card) when `stereo_warp_kernel` is
"on", else `F.grid_sample` ("auto" and "off": the JAX package's "auto"
always selects its gather, `BANDED_WARP_MIN_WIDTH = inf`). The temporal
(pose) frames always take `F.grid_sample` (`ops/image.
grid_sample_border`), as JAX's take its gather: their grids are not
row-banded, so K3 does not apply.

The automask tie-break noise is 1e-5 * N(0, 1) per loss scale. `noise` is
a `torch.Generator` (on the batch's device) to draw it from, or a mapping
{scale: (N, H, W, 1) standard-normal tensor} to inject given draws.

Under data parallelism (`parallel/mesh.py`) every term is the global
batch's, as under JAX's data mesh: the ratio terms (reprojection, hint,
disparity L1) divide global sums, the means (smoothness, the
monodepth2 loss) are global means, and the noise is this rank's rows of
one draw for the global batch. The logged losses are global. With one
rank every term is computed as before.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from ..ops.geometry import (backproject_depth, disp_to_depth, project_3d,
                            transformation_from_parameters)
from ..ops.image import get_smooth_loss, grid_sample_border, resize_bilinear
from ..ops.ssim import ssim as ssim_fn
from ..ops.warp import grid_sample_border_banded
from ..parallel import mesh

Tensor = torch.Tensor
Noise = Union[torch.Generator, Mapping[int, Tensor]]

# Width from which "auto" would take the banded warp: never, as in the
# JAX package (a TPU finding; which sampler wins on the H100 is measured
# by chip_smoke.py and written in PERF.md).
BANDED_WARP_MIN_WIDTH = float("inf")


def use_banded_warp(opts) -> bool:
    """Resolve stereo_warp_kernel: "auto" (or None) by width, "on" / "off"
    (or bools) forced."""
    v = getattr(opts, "stereo_warp_kernel", "auto")
    if isinstance(v, bool):
        return v
    if v in (None, "auto"):
        return opts.width >= BANDED_WARP_MIN_WIDTH
    if v in ("on", "true", "1"):
        return True
    if v in ("off", "false", "0"):
        return False
    raise ValueError(f"stereo_warp_kernel must be auto/on/off, got {v!r}")


def compute_reprojection_loss(pred: Tensor, target: Tensor,
                              no_ssim: bool = False) -> Tensor:
    """0.85 * SSIM + 0.15 * L1 per pixel, channel-meaned. (N, H, W, 1)."""
    l1 = torch.abs(target - pred).mean(dim=-1, keepdim=True)
    if no_ssim:
        return l1
    s = ssim_fn(pred, target).mean(dim=-1, keepdim=True)
    return 0.85 * s + 0.15 * l1


def _stereo_sampler(opts):
    return (grid_sample_border_banded if use_banded_warp(opts)
            else grid_sample_border)


def _pose_frame_T(pose_T: Dict, frame_id: int, depth: Tensor, opts):
    """The warp pose of temporal frame `frame_id`: the pose net's
    cam_T_cam, or under PoseCNN the velocity-scaled pose
    (`trainer.py:353-364`): T recomputed per scale with the translation
    times this scale's mean inverse depth. Like JAX and the reference, it
    reads [:, 0] in both pose modes (even "all", whose cam_T_cam read
    [:, i])."""
    if opts.pose_model_type != "posecnn":
        return pose_T[("cam_T_cam", 0, frame_id)]
    aa = pose_T[("axisangle", 0, frame_id)]
    tr = pose_T[("translation", 0, frame_id)]
    mean_inv_depth = (1.0 / depth).mean(dim=(1, 2), keepdim=True)  # N,1,1,1
    return transformation_from_parameters(
        aa[:, 0], tr[:, 0] * mean_inv_depth[:, 0], invert=frame_id < 0)


def generate_images_pred(inputs: Dict, outputs: Dict, opts,
                         pose_T: Optional[Dict] = None) -> Dict:
    """Warp the source frames into the target view per loss scale. Adds
    ("depth", 0, s), ("sample", fid, s), ("color", fid, s) and, under depth
    hints, ("color_depth_hint", "s", 0). `pose_T` holds the pose net's
    ("axisangle" / "translation" / "cam_T_cam", 0, fid) of the temporal
    frames (`train/kitti.predict_poses`)."""
    h_full, w_full = opts.height, opts.width
    for scale in opts.loss_scales:
        disp = outputs[("disp", scale)]
        if opts.v1_multiscale:
            source_scale = scale
        else:
            disp = resize_bilinear(disp, h_full, w_full)
            source_scale = 0
        _, depth = disp_to_depth(disp, opts.min_depth, opts.max_depth)
        outputs[("depth", 0, scale)] = depth
        h, w = depth.shape[1], depth.shape[2]
        for frame_id in opts.all_frame_ids[1:]:
            if frame_id == "s":
                t, sampler = inputs[("stereo_T",)], _stereo_sampler(opts)
            else:
                t = _pose_frame_T(pose_T, frame_id, depth, opts)
                sampler = grid_sample_border
            cam_points = backproject_depth(depth,
                                           inputs[("inv_K", source_scale)])
            pix = project_3d(cam_points, inputs[("K", source_scale)], t, h, w)
            outputs[("sample", str(frame_id), scale)] = pix
            outputs[("color", str(frame_id), scale)] = sampler(
                inputs[("color", str(frame_id), source_scale)], pix)

    if opts.use_depth_hints and "s" in opts.all_frame_ids[1:]:
        depth = inputs[("depth_hint",)]
        cam_points = backproject_depth(depth, inputs[("inv_K", 0)])
        pix = project_3d(cam_points, inputs[("K", 0)], inputs[("stereo_T",)],
                         depth.shape[1], depth.shape[2])
        outputs[("color_depth_hint", "s", 0)] = _stereo_sampler(opts)(
            inputs[("color", "s", 0)], pix)
    return outputs


def compute_proxy_supervised_loss(pred: Tensor, target: Tensor,
                                  valid_pixels: Tensor,
                                  loss_mask: Tensor) -> Tensor:
    """log(|t - p| + 1) hint loss, masked."""
    loss = torch.log(torch.abs(target - pred) + 1.0) * valid_pixels
    return loss * loss_mask


def compute_loss_masks(reprojection_loss: Tensor,
                       identity_reprojection_loss: Optional[Tensor],
                       depth_hint_reprojection_loss: Optional[Tensor]):
    """Elementwise argmin over [reproj, identity, hint]. Returns
    (reprojection_loss_mask, depth_hint_loss_mask or None)."""
    dt = reprojection_loss.dtype
    if identity_reprojection_loss is None:
        reprojection_loss_mask = torch.ones_like(reprojection_loss)
        depth_hint_loss_mask = None
        if depth_hint_reprojection_loss is not None:
            idxs = torch.argmin(torch.cat(
                [reprojection_loss, depth_hint_reprojection_loss], dim=-1),
                dim=-1, keepdim=True)
            depth_hint_loss_mask = (idxs == 1).to(dt)
        return reprojection_loss_mask, depth_hint_loss_mask

    parts = [reprojection_loss, identity_reprojection_loss]
    if depth_hint_reprojection_loss is not None:
        parts.append(depth_hint_reprojection_loss)
    idxs = torch.argmin(torch.cat(parts, dim=-1), dim=-1, keepdim=True)
    reprojection_loss_mask = (idxs != 1).to(dt)
    depth_hint_loss_mask = ((idxs == 2).to(dt)
                            if depth_hint_reprojection_loss is not None
                            else None)
    return reprojection_loss_mask, depth_hint_loss_mask


def _automask_noise(noise: Noise, scale: int, like: Tensor) -> Tensor:
    if isinstance(noise, torch.Generator):
        draw = mesh.randn_rows(like.shape, noise, like.dtype, like.device)
    else:
        draw = noise[scale].to(like.device, like.dtype)
    return draw * 1e-5


def _reproj_stack(inputs, outputs, opts, scale, source_scale, target):
    reproj = torch.cat([compute_reprojection_loss(
        outputs[("color", str(fid), scale)], target, opts.no_ssim)
        for fid in opts.all_frame_ids[1:]], dim=-1)
    ident = None
    if not opts.disable_automasking:
        ident = torch.cat([compute_reprojection_loss(
            inputs[("color", str(fid), source_scale)], target, opts.no_ssim)
            for fid in opts.all_frame_ids[1:]], dim=-1)
    return reproj, ident


def compute_losses_hints(inputs: Dict, outputs: Dict, opts,
                         noise: Noise) -> Dict:
    """Reprojection + proxy-hint + smoothness (`trainer.py:457-560`)."""
    losses = {}
    total_loss = 0.0
    if opts.use_depth_hints:
        hint_reproj = compute_reprojection_loss(
            outputs[("color_depth_hint", "s", 0)], inputs[("color", "0", 0)],
            opts.no_ssim)
        hint_reproj = hint_reproj + 1000.0 * (1.0
                                              - inputs[("depth_hint_mask",)])
    else:
        hint_reproj = None

    for scale in opts.loss_scales:
        source_scale = scale if opts.v1_multiscale else 0
        disp = outputs[("disp", scale)]
        color = inputs[("color", "0", scale)]
        target = inputs[("color", "0", source_scale)]
        reproj, ident = _reproj_stack(inputs, outputs, opts, scale,
                                      source_scale, target)
        reduce = ((lambda t: t.mean(dim=-1, keepdim=True))
                  if opts.avg_reprojection
                  else (lambda t: t.min(dim=-1, keepdim=True)[0]))
        reproj = reduce(reproj)
        if ident is not None:
            ident = reduce(ident)
            ident = ident + _automask_noise(noise, scale, ident)

        reproj_mask, hint_mask = compute_loss_masks(reproj, ident,
                                                    hint_reproj)
        num, den = mesh.global_sums(reproj * reproj_mask, reproj_mask)
        reproj_term = num / (den + 1e-7)
        losses[f"reproj_loss/{scale}"] = reproj_term
        outputs[("identity_selection", scale)] = 1.0 - reproj_mask

        loss = reproj_term
        if opts.use_depth_hints:
            hint_loss = compute_proxy_supervised_loss(
                outputs[("depth", 0, scale)], inputs[("depth_hint",)],
                inputs[("depth_hint_mask",)], hint_mask)
            num, den = mesh.global_sums(hint_loss, hint_mask)
            hint_term = num / (den + 1e-7)
            outputs[("depth_hint_pixels", scale)] = hint_mask
            losses[f"depth_hint_loss/{scale}"] = hint_term
            loss = loss + hint_term

        # opt-in scratch-training stabilizer (not in the reference): masked
        # L1 between this scale's disparity and the hint disparity, applied
        # wherever the hint is valid
        w_disp = getattr(opts, "hint_disp_l1_weight", 0.0)
        if opts.use_depth_hints and w_disp:
            dh = inputs[("disp_hint",)]
            mask = inputs[("depth_hint_mask",)]
            disp_full = (disp if disp.shape[1:3] == dh.shape[1:3]
                         else resize_bilinear(disp, dh.shape[1], dh.shape[2]))
            if getattr(opts, "hint_disp_l1_space", "log") == "log":
                c = 0.02
                l1 = torch.abs(torch.log(disp_full + c)
                               - torch.log(dh + c)) * mask
            else:
                l1 = torch.abs(disp_full - dh) * mask
            num, den = mesh.global_sums(l1, mask)
            disp_term = w_disp * num / (den + 1e-7)
            losses[f"hint_disp_l1/{scale}"] = disp_term
            loss = loss + disp_term

        mean_disp = disp.mean(dim=(1, 2), keepdim=True)
        norm_disp = disp / (mean_disp + 1e-7)
        smooth = get_smooth_loss(norm_disp, color, opts.smoothness_gamma)
        loss = loss + opts.disparity_smoothness * smooth / (2.0 ** scale)
        total_loss = total_loss + loss
        losses[f"loss/{scale}"] = loss

    losses["loss"] = total_loss / len(opts.scales)
    return losses


def compute_losses_mdp(inputs: Dict, outputs: Dict, opts,
                       noise: Noise) -> Dict:
    """Monodepth2-style loss without hints (`trainer.py:562-646`), with the
    reprojection term in the total."""
    losses = {}
    total_loss = 0.0
    for scale in opts.loss_scales:
        source_scale = scale if (opts.v1_multiscale or scale <= 0) else 0
        if ("disp", scale) not in outputs:
            continue
        disp = outputs[("disp", scale)]
        color = inputs[("color", "0", scale)]
        target = inputs[("color", "0", source_scale)]
        reproj, ident = _reproj_stack(inputs, outputs, opts, scale,
                                      source_scale, target)
        if opts.avg_reprojection:
            reproj = reproj.mean(dim=-1, keepdim=True)
        if ident is not None:
            if opts.avg_reprojection:
                ident = ident.mean(dim=-1, keepdim=True)
            ident = ident + _automask_noise(noise, scale, ident)
            combined = torch.cat([ident, reproj], dim=-1)
        else:
            combined = reproj

        if combined.shape[-1] == 1:
            to_optimise = combined[..., 0]
        else:
            to_optimise, idxs = torch.min(combined, dim=-1)
            if ident is not None:
                outputs[("identity_selection", scale)] = (
                    idxs >= ident.shape[-1]).to(disp.dtype)
        loss = mesh.global_mean(to_optimise)

        mean_disp = disp.mean(dim=(1, 2), keepdim=True)
        norm_disp = disp / (mean_disp + 1e-7)
        if opts.disparity_smoothness != 0:
            smooth = get_smooth_loss(norm_disp, color, opts.smoothness_gamma)
            loss = loss + (opts.disparity_smoothness * smooth / (2.0 ** scale))
        total_loss = total_loss + loss
        losses[f"loss/{scale}"] = loss

    losses["loss"] = total_loss / len(opts.scales)
    return losses
