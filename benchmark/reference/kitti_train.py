"""Plain reference of the KITTI training step of `kitti_r18_640x192`:
stereo + depth hints (Depth Hints on monodepth2, WaveletMonoDepth's
`KITTI/trainer.py`), the dense wavelet decoder, Adam.

One step, from a batch in the loader's layout (uint8 frames per scale,
per-item colour-jitter factors, intrinsics, the stereo pose, the depth
hints) and the automask noise:

- frames to float [0, 1]; the encoder's input is the target frame
  jittered by PIL's enhance chain in float (brightness, contrast against
  the mean luminance, saturation against the luminance, hue rotated by
  hue * 255/256 of a turn in HSV);
- ResNet18 with train-mode BatchNorm (batch statistics), the dense
  wavelet decoder, disparities at scales 0-3, each resized bilinearly to
  full size and turned into depth (min 0.1, max 100);
- the stereo frame warped into the target view by each scale's depth
  (backprojection with inv_K, projection with K and the stereo pose,
  bilinear sampling with border padding), and by the depth hint;
- per scale the photometric loss (0.85 SSIM + 0.15 L1), its identity
  twin plus 1e-5 * noise, the hint's loss plus 1000 where the hint is
  invalid; the per-pixel argmin of the three picks the reprojection mask
  (not the identity) and the hint mask (the hint), the masked means of
  the reprojection loss and of log(|hint depth - depth| + 1), and 1e-3 x
  the edge-aware smoothness of the mean-normalised disparity / 2^scale;
  the loss is the mean over the four scales;
- Adam (0.9, 0.999, eps 1e-8) with L2 weight decay 1e-5 added to the
  gradient, on every encoder parameter and the decoder's weights (not its
  biases), at lr 1e-4.
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from . import kitti_r18_640x192 as net
from .common import Precision, bn_train, matmul

Tensor = torch.Tensor

MIN_DEPTH, MAX_DEPTH = 0.1, 100.0
SCALES = (0, 1, 2, 3)
SMOOTHNESS = 1e-3
BETAS, EPS, WEIGHT_DECAY, LR = (0.9, 0.999), 1e-8, 1e-5, 1e-4
LUMA = (0.299, 0.587, 0.114)


# --- the jitter --------------------------------------------------------------

def _luma(x: Tensor) -> Tensor:
    return LUMA[0] * x[:, 0:1] + LUMA[1] * x[:, 1:2] + LUMA[2] * x[:, 2:3]


def color_jitter(img: Tensor, f: Tensor) -> Tensor:
    """img (N, 3, H, W) in [0, 1]; f (N, 4): brightness, contrast,
    saturation, hue."""
    b, c, s, h = (f[:, k].view(-1, 1, 1, 1) for k in range(4))
    x = torch.clamp(img * b, 0.0, 1.0)
    mean = _luma(x).mean(dim=(2, 3), keepdim=True)
    x = torch.clamp(mean + (x - mean) * c, 0.0, 1.0)
    luma = _luma(x)
    x = torch.clamp(luma + (x - luma) * s, 0.0, 1.0)
    r, g, bl = x[:, 0], x[:, 1], x[:, 2]
    mx = torch.maximum(r, torch.maximum(g, bl))
    mn = torch.minimum(r, torch.minimum(g, bl))
    d = mx - mn
    sd = torch.where(d == 0, torch.ones_like(d), d)
    hue = torch.where(mx == r, ((g - bl) / sd) % 6.0,
                      torch.where(mx == g, (bl - r) / sd + 2.0,
                                  (r - g) / sd + 4.0))
    hue = torch.where(d == 0, torch.zeros_like(hue), hue) / 6.0
    sat = torch.where(mx == 0, torch.zeros_like(d),
                      d / torch.where(mx == 0, torch.ones_like(mx), mx))
    hue = (hue + h[:, 0] * (255.0 / 256.0)) % 1.0
    i = torch.floor(hue * 6.0)
    fr = hue * 6.0 - i
    v = mx
    pp, q, t = v * (1 - sat), v * (1 - fr * sat), v * (1 - (1 - fr) * sat)
    i = i.to(torch.int32) % 6
    table = ((v, t, pp), (q, v, pp), (pp, v, t), (pp, q, v), (t, pp, v),
             (v, pp, q))
    chans = []
    for ch in range(3):
        out = table[5][ch]
        for k in range(4, -1, -1):
            out = torch.where(i == k, table[k][ch], out)
        chans.append(out)
    return torch.clamp(torch.stack(chans, dim=1), 0.0, 1.0)


# --- geometry and losses -----------------------------------------------------

def backproject(depth: Tensor, inv_k: Tensor, p: Precision) -> Tensor:
    """depth (N, 1, H, W) -> homogeneous camera points (N, 4, H*W)."""
    n, _, h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=depth.dtype,
                                         device=depth.device),
                            torch.arange(w, dtype=depth.dtype,
                                         device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(h * w, dtype=depth.dtype,
                                  device=depth.device)])
    cam = matmul(inv_k[:, :3, :3], pix, p) * depth.reshape(n, 1, h * w)
    return torch.cat([cam, torch.ones_like(cam[:, :1])], 1)


def project(points: Tensor, k: Tensor, t: Tensor, h: int, w: int,
            p: Precision) -> Tensor:
    """Camera points -> the sampling grid (N, H, W, 2), (x, y) in [-1, 1]
    (align_corners=False normalisation by W - 1 and H - 1, as the
    reference's Project3D)."""
    n = points.shape[0]
    cam = matmul(matmul(k, t, p)[:, :3, :], points, p)
    pix = cam[:, :2] / (cam[:, 2:3] + 1e-7)
    pix = pix.reshape(n, 2, h, w).permute(0, 2, 3, 1)
    return torch.stack([(pix[..., 0] / (w - 1) - 0.5) * 2,
                        (pix[..., 1] / (h - 1) - 0.5) * 2], -1)


def warp(img: Tensor, grid: Tensor) -> Tensor:
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                         align_corners=False)


def ssim(x: Tensor, y: Tensor) -> Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    y = F.pad(y, (1, 1, 1, 1), mode="reflect")
    mx, my = F.avg_pool2d(x, 3, 1), F.avg_pool2d(y, 3, 1)
    sx = F.avg_pool2d(x * x, 3, 1) - mx * mx
    sy = F.avg_pool2d(y * y, 3, 1) - my * my
    sxy = F.avg_pool2d(x * y, 3, 1) - mx * my
    num = (2 * mx * my + c1) * (2 * sxy + c2)
    den = (mx ** 2 + my ** 2 + c1) * (sx + sy + c2)
    return torch.clamp((1 - num / den) / 2, 0, 1)


def reprojection(pred: Tensor, target: Tensor) -> Tensor:
    l1 = (target - pred).abs().mean(1, keepdim=True)
    return 0.85 * ssim(pred, target).mean(1, keepdim=True) + 0.15 * l1


def smoothness(disp: Tensor, img: Tensor) -> Tensor:
    gdx = (disp[:, :, :, :-1] - disp[:, :, :, 1:]).abs()
    gdy = (disp[:, :, :-1, :] - disp[:, :, 1:, :]).abs()
    gix = (img[:, :, :, :-1] - img[:, :, :, 1:]).abs().mean(1, keepdim=True)
    giy = (img[:, :, :-1, :] - img[:, :, 1:, :]).abs().mean(1, keepdim=True)
    return ((gdx * torch.exp(-2.0 * gix)).mean()
            + (gdy * torch.exp(-2.0 * giy)).mean())


def to_depth(disp: Tensor) -> Tensor:
    lo, hi = 1.0 / MAX_DEPTH, 1.0 / MIN_DEPTH
    return 1.0 / (lo + (hi - lo) * disp)


def losses(params: dict, batch: dict, noise: dict, p: Precision) -> dict:
    """The step's forward and losses: {"loss", "reproj_loss/s",
    "depth_hint_loss/s", "loss/s"}."""
    dt = params["encoder.conv1.weight"].dtype

    def nchw_f(t):
        return t.permute(0, 3, 1, 2).to(dt)
    color = {(fid, s): nchw_f(v) / 255.0 for (kind, fid, s), v in
             ((k, v) for k, v in batch.items() if k[0] == "color_u8")}
    x = color_jitter(color[("0", 0)], batch[("jitter",)].to(dt))
    feats = net.encoder(x, params, p, bn=bn_train)
    disps = net.decoder(feats, params, p)
    h, w = x.shape[2], x.shape[3]
    k0, inv_k0 = batch[("K", 0)].to(dt), batch[("inv_K", 0)].to(dt)
    t = batch[("stereo_T",)].to(dt)
    target, other = color[("0", 0)], color[("s", 0)]
    hint = nchw_f(batch[("depth_hint",)])
    hint_valid = nchw_f(batch[("depth_hint_mask",)])
    hint_grid = project(backproject(hint, inv_k0, p), k0, t, h, w, p)
    hint_reproj = (reprojection(warp(other, hint_grid), target)
                   + 1000.0 * (1.0 - hint_valid))
    ident_base = reprojection(other, target)
    out, total = {}, 0.0
    for s in SCALES:
        disp = disps[("disp", s)]
        depth = to_depth(F.interpolate(disp, (h, w), mode="bilinear",
                                       align_corners=False))
        grid = project(backproject(depth, inv_k0, p), k0, t, h, w, p)
        reproj = reprojection(warp(other, grid), target)
        ident = ident_base + 1e-5 * nchw_f(noise[s])
        idx = torch.argmin(torch.cat([reproj, ident, hint_reproj], 1), 1,
                           keepdim=True)
        rmask = (idx != 1).to(reproj.dtype)
        hmask = (idx == 2).to(reproj.dtype)
        rterm = (reproj * rmask).sum() / (rmask.sum() + 1e-7)
        hloss = torch.log((hint - depth).abs() + 1.0) * hint_valid * hmask
        hterm = hloss.sum() / (hmask.sum() + 1e-7)
        norm = disp / (disp.mean(dim=(2, 3), keepdim=True) + 1e-7)
        loss = rterm + hterm + SMOOTHNESS * smoothness(
            norm, color[("0", s)]) / (2.0 ** s)
        out[f"reproj_loss/{s}"], out[f"depth_hint_loss/{s}"] = rterm, hterm
        out[f"loss/{s}"] = loss
        total = total + loss
    out["loss"] = total / len(SCALES)
    return out


# --- the step ----------------------------------------------------------------

def decays(name: str) -> bool:
    """L2 weight decay on every encoder parameter and the decoder's
    weights, not the decoder's biases."""
    return name.startswith("encoder.") or not name.endswith(".bias")


class Adam:
    """torch.optim.Adam's update with L2 decay, written out."""

    def __init__(self, params: dict):
        self.params = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.first_grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = BETAS
        seen = {}
        for k, prm in self.params.items():
            g = prm.grad
            if decays(k):
                g = g + WEIGHT_DECAY * prm
            seen[k] = g.clone()
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            prm.sub_(LR * mhat / (vhat.sqrt() + EPS))
            prm.grad = None
        if self.first_grad is None:
            self.first_grad = seen


def train(weights: dict, batches: list, noises: list, steps: int,
          precision: str = "f32") -> dict:
    """`steps` reference steps from `weights` ({key: tensor}, parameters
    and buffers) on batches[i], noises[i]: {"losses": [loss per step],
    "first_grad": {name: gradient with decay, step 1}, "change": {name:
    parameter after the steps minus before}}."""
    if precision == "f64":          # a witness of float32's own rounding
        def f64(t):
            return t.double() if t.is_floating_point() else t
        weights = {k: f64(v) for k, v in weights.items()}
        batches = [{k: f64(v) for k, v in b.items()} for b in batches]
        noises = [{k: f64(v) for k, v in n.items()} for n in noises]
        precision = "f32"
    p = Precision(precision)
    names = [k for k in weights if not k.rsplit(".", 1)[1] in
             ("running_mean", "running_var", "num_batches_tracked")]
    params = {k: weights[k].detach().clone().requires_grad_(True)
              for k in names}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params)
    out = []
    for i in range(steps):
        loss = losses(params, batches[i], noises[i], p)["loss"]
        loss.backward()
        opt.step()
        out.append(float(loss.detach()))
    return {"losses": out, "first_grad": opt.first_grad,
            "change": {k: params[k].detach() - start[k] for k in names}}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's}."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return {k: abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med,
                                                            1e-30)
            for k in ref if keep is None or k in keep}


def moving_leaves(first_grad: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under Adam by round-off alone)."""
    norms = {k: float(v.norm()) for k, v in first_grad.items()}
    med = statistics.median(norms.values())
    return {k for k, v in norms.items() if v >= 1e-3 * med}

