"""TensorBoard logging: scalars, the training visuals and the console line.

Counterpart of `wavelet_monodepth_tpu/utils/logging.py` (the reference's
tensorboardX use, `trainer.py:141-143,202-226,661-720`;
`NYUv2/train.py:113-163`): separate train/val writers, loss scalars, up
to 4 images per batch (inputs, warps, automasks, disparities) and the
per-scale wavelet coefficient images, histograms and min/max scalars,
which show how sparse the coefficients are (SURVEY section 5.5).
`SummaryLogger` is a no-op without tensorboardX; `writers=` puts other
objects with tensorboardX's `add_scalar` / `add_image` /
`add_histogram` in its place. Tags, order and normalisation are JAX's.

The port's images are NHWC, as JAX's. The visuals copy the rows they
log of every tensor they read to the host in one pass (asynchronous
copies and one synchronisation per call), then work in numpy, as JAX
does on its host arrays. `TrainTimer` formats the reference's progress
line. Under data parallelism only rank 0 holds writers, so the visuals
show rank 0's rows of the global batch (JAX's `mesh.local_rows`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch


def normalize_image_np(x: np.ndarray) -> np.ndarray:
    mi, ma = x.min(), x.max()
    return (x - mi) / (ma - mi + 1e-5)


def _host_rows(tree: Dict, keys: Iterable, n: int) -> Dict:
    """{key: tree[key][:n] as float32 numpy} for the keys tree holds (None
    values skipped): asynchronous device-to-host copies, then one
    synchronisation. uint8 tensors stay uint8."""
    staged, on_card = {}, False
    for k in keys:
        v = tree.get(k)
        if v is None:
            continue
        if not torch.is_tensor(v):
            staged[k] = np.asarray(v)[:n]
            continue
        v = v[:n].detach()
        if v.is_floating_point() and v.dtype != torch.float32:
            v = v.float()
        on_card |= v.is_cuda
        staged[k] = v.to("cpu", non_blocking=True)
    if on_card:
        torch.cuda.synchronize()
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in staged.items()}


class SummaryLogger:
    """Separate train/val writers; a no-op if tensorboardX is missing.
    writers: {mode: writer} in place of tensorboardX's."""

    def __init__(self, log_path: str, modes=("train", "val"),
                 writers: Optional[Dict] = None):
        self.writers = {}
        if writers is not None:
            self.writers = dict(writers)
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        for m in modes:
            self.writers[m] = SummaryWriter(os.path.join(log_path, m))

    def active(self, mode: str) -> bool:
        """Whether `mode` has a writer (the visuals cost a forward)."""
        return mode in self.writers

    def scalars(self, mode: str, scalars: Dict[str, float], step: int):
        w = self.writers.get(mode)
        if w is None:
            return
        for k, v in scalars.items():
            w.add_scalar(str(k), float(v), step)

    def image(self, mode: str, tag: str, img_hwc: np.ndarray, step: int):
        w = self.writers.get(mode)
        if w is None:
            return
        img = np.asarray(img_hwc)
        if img.ndim == 3:
            img = img.transpose(2, 0, 1)
        elif img.ndim == 2:        # masks/automasks land channel-less
            img = img[None]
        w.add_image(tag, img, step)

    def histogram(self, mode: str, tag: str, values, step: int):
        w = self.writers.get(mode)
        if w is None:
            return
        w.add_histogram(tag, np.asarray(values), step)

    def log_kitti_visuals(self, mode: str, inputs: Dict, outputs: Dict,
                          opts, step: int, max_images: int = 4):
        """`trainer.py:661-720` image set."""
        if mode not in self.writers:
            return
        n = min(max_images, next(iter(inputs.values())).shape[0])
        fids = [str(f) for f in opts.all_frame_ids]
        inputs = _host_rows(inputs, [(c, f, 0) for f in fids
                                     for c in ("color", "color_u8")]
                            + [("disp_hint",)], n)
        okeys = [("color", f, 0) for f in fids]
        for scale in opts.scales:
            okeys += [("identity_selection", scale), ("disp", scale)]
            okeys += [("wavelets", scale, c) for c in ("LL", "LH", "HL",
                                                       "HH")]
        okeys += [("depth_hint_pixels", 0), ("color_depth_hint", "s", 0)]
        outputs = _host_rows(outputs, okeys, n)
        for j in range(n):
            for fid in opts.all_frame_ids:
                key = ("color", str(fid), 0)
                if key in inputs:
                    self.image(mode, f"color_{fid}_0/{j}", inputs[key][j],
                               step)
                elif ("color_u8", str(fid), 0) in inputs:
                    # uint8 device-augment feed (data/kitti.py)
                    self.image(mode, f"color_{fid}_0/{j}",
                               inputs[("color_u8", str(fid), 0)][j]
                               .astype("float32") / 255.0, step)
                if key in outputs:
                    self.image(mode, f"color_pred_{fid}_0/{j}",
                               outputs[key][j], step)
            for scale in opts.scales:
                sel = ("identity_selection", scale)
                if sel in outputs:
                    self.image(mode, f"automask_{scale}/{j}",
                               outputs[sel][j], step)
                if opts.use_wavelets:
                    for coeff in ("LL", "LH", "HL", "HH"):
                        key = ("wavelets", scale, coeff)
                        if key in outputs:
                            img = outputs[key][j]
                            self.image(mode, f"{coeff}_{scale}/{j}",
                                       normalize_image_np(
                                           img.mean(-1, keepdims=True)),
                                       step)
                            self.histogram(mode,
                                           f"hist_{coeff}_{scale}/{j}",
                                           img, step)
                            self.scalars(mode,
                                         {f"min/{coeff}_{scale}/{j}":
                                              img.min(),
                                          f"max/{coeff}_{scale}/{j}":
                                              img.max()}, step)
                dkey = ("disp", scale)
                if dkey in outputs:
                    self.image(mode, f"disp_{scale}/{j}",
                               normalize_image_np(outputs[dkey][j]), step)
            # depth-hint visuals at scale 0 / frame "s"
            # (`trainer.py:685-696`): hint-selected pixels, the hint
            # disparity itself, and the hint-warped color
            if getattr(opts, "use_depth_hints", False):
                if ("depth_hint_pixels", 0) in outputs:
                    self.image(mode, f"depth_hints_mask0/{j}",
                               outputs[("depth_hint_pixels", 0)][j], step)
                if ("disp_hint",) in inputs:
                    self.image(mode, f"disp_hints/{j}",
                               normalize_image_np(inputs[("disp_hint",)][j]),
                               step)
                if ("color_depth_hint", "s", 0) in outputs:
                    self.image(mode, f"color_depth_hint0/{j}",
                               outputs[("color_depth_hint", "s", 0)][j],
                               step)

    def log_nyu_visuals(self, mode: str, image, depth_n, outputs: Dict,
                        gt_wavelets=None, step: int = 0,
                        max_images: int = 4, log_histogram: bool = True):
        """`NYUv2/train.py:113-163` image set: input color, GT disparity,
        per-scale predicted disparities, and pred-vs-GT wavelet
        coefficient images (+histograms). `gt_wavelets` is the
        (yl, [(lh, hl, hh) per level, finest first]) pair of
        `ops.wavelets.haar_dwt_J(depth_n, 4)`: level index == scale, the
        reference's `yh_gt[scale]` keying (`train.py:299-302`)."""
        if mode not in self.writers:
            return
        n = min(max_images, image.shape[0])
        keys = [("disp", s) for s in range(4)]
        keys += [("wavelets", s, c) for s in range(4)
                 for c in ("LH", "HL", "HH", "LL")]
        tree = dict(outputs)
        tree["image"], tree["depth_n"] = image, depth_n
        if gt_wavelets is not None:
            yl_gt, highs = gt_wavelets
            tree["yl_gt"] = yl_gt
            for lvl, bands in enumerate(highs):
                for ci, band in enumerate(bands):
                    tree[("gt", lvl, ci)] = band
            keys += ["yl_gt"] + [("gt", lvl, ci) for lvl in range(len(highs))
                                 for ci in range(3)]
        host = _host_rows(tree, keys + ["image", "depth_n"], n)
        for j in range(n):
            self.image(mode, f"color/{j}", host["image"][j], step)
            self.image(mode, f"disp_0_gt/{j}",
                       normalize_image_np(host["depth_n"][j]), step)
            for scale in range(4):
                dkey = ("disp", scale)
                if dkey in host:
                    self.image(mode, f"disp_{scale}_pred/{j}",
                               normalize_image_np(host[dkey][j]), step)
                coeffs = [("LH", 0), ("HL", 1), ("HH", 2)]
                if scale == 3:
                    coeffs = coeffs + [("LL", None)]
                for coeff, ci in coeffs:
                    key = ("wavelets", scale, coeff)
                    if key not in host:
                        continue
                    pred = host[key][j]
                    self.image(mode, f"{coeff}_{scale}_pred/{j}",
                               normalize_image_np(pred), step)
                    if log_histogram:
                        self.histogram(mode,
                                       f"hist_{coeff}_{scale}_pred/{j}",
                                       pred, step)
                    if gt_wavelets is None:
                        continue
                    gt = (host["yl_gt"][j] if ci is None
                          else host[("gt", scale, ci)][j])
                    self.image(mode, f"{coeff}_{scale}_gt/{j}",
                               normalize_image_np(gt), step)
                    if log_histogram:
                        self.histogram(mode,
                                       f"hist_{coeff}_{scale}_gt/{j}",
                                       gt, step)

    def close(self):
        for w in self.writers.values():
            w.close()


def sec_to_hm_str(t: float) -> str:
    """`KITTI/utils.py:37-48`."""
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return f"{t:02d}h{m:02d}m{s:02d}s"


class TrainTimer:
    """The reference's progress line. examples/s is the windowed wall
    rate (steps since the previous line over the wall time since then):
    steps are queued on the card without a sync, so a per-step duration
    measures the enqueue, not the step."""

    def __init__(self, num_total_steps: int):
        self.start_time = time.time()
        self.num_total_steps = num_total_steps
        self._last_log_time = self.start_time
        self._last_log_step = 0

    def log_line(self, epoch: int, batch_idx: int, step: int,
                 batch_size: int, durations: Dict[str, float],
                 loss: float) -> str:
        now = time.time()
        dsteps = max(step - self._last_log_step, 1)
        samples_per_sec = (batch_size * dsteps
                           / max(now - self._last_log_time, 1e-9))
        self._last_log_time, self._last_log_step = now, step
        elapsed = now - self.start_time
        left = (self.num_total_steps / step - 1.0) * elapsed if step else 0
        return (f"epoch {epoch:>3} | batch {batch_idx:>6} | "
                f"forward: {durations.get('batch_process', 0):2.1f}s "
                f"(examples/s: {samples_per_sec:5.1f}) | "
                f"dataloading: {durations.get('dataloading', 0):2.1f}s | "
                f"loss: {loss:.5f} | elapsed: {sec_to_hm_str(elapsed)} | "
                f"left: {sec_to_hm_str(left)}")
