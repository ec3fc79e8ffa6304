"""NYUv2 labeled-set evaluation with edge (depth-boundary) metrics.

Counterpart of `wavelet_monodepth_tpu/eval/nyu_eval.py`
(`NYUv2/evaluate.py:19-107`, `NYUv2/utils.py:85-272`): border-crop 16
-> bilinear resize to 640x480 (align_corners=True) -> the model's
forward (dense or sparse) -> /100 cm -> m (or DepthNorm in disparity
mode) -> the reference's downscale / replicate-pad / x2-upscale -> clamp
[0.4, 10] -> Eigen crop [20:460, 24:616] -> metrics. The image side runs
in torch on the forward's device (uint8 shipped, cast there); the scoring
runs on the host in float64 numpy / scipy.

Edge metrics: Canny on the normalised prediction against NYUv2-OC++ GT
edges, truncated chamfer distances -> (eps_acc, eps_comp). `canny` is the
port's own copy of the JAX package's port of scikit-image's (<= 0.18)
`feature.canny`: masked-normalised constant-mode Gaussian smoothing,
Sobel gradients, sector-wise interpolated non-maximum suppression and
8-connected hysteresis, border pixels excluded by the 3x3 mask erosion.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from scipy import ndimage

from ..ops.image import pad2d, resize_bilinear

EIGEN_CROP = (20, 459, 24, 615)   # `evaluate.py:56`


def canny(image: np.ndarray, sigma: float = np.sqrt(2),
          low_threshold: float = 0.15,
          high_threshold: float = 0.3) -> np.ndarray:
    """skimage.feature.canny-exact edge detector (absolute thresholds on
    Sobel gradient magnitude). See module docstring for provenance."""
    image = np.asarray(image, dtype=np.float64)
    mask = np.ones(image.shape, dtype=bool)

    # --- smoothing: gaussian(image)/gaussian(ones), mode='constant' ------
    bleed_over = ndimage.gaussian_filter(mask.astype(np.float64), sigma,
                                         mode="constant")
    smoothed = ndimage.gaussian_filter(image, sigma, mode="constant")
    smoothed = smoothed / (bleed_over + np.finfo(float).eps)

    jsobel = ndimage.sobel(smoothed, axis=1)
    isobel = ndimage.sobel(smoothed, axis=0)
    abs_i = np.abs(isobel)
    abs_j = np.abs(jsobel)
    magnitude = np.hypot(isobel, jsobel)

    eroded_mask = ndimage.binary_erosion(mask, np.ones((3, 3), bool),
                                         border_value=0)
    eroded_mask = eroded_mask & (magnitude > 0)

    local_maxima = np.zeros(image.shape, bool)

    def _sector(pts, w, plus_1, plus_2, minus_1, minus_2):
        """Interpolated NMS for one gradient sector.

        plus/minus_{1,2} are ((mag_slice), (pts_slice)) index pairs:
        neighbor values c1/c2 along +/- gradient; keep pts where
        m >= c2*w + c1*(1-w) on both sides.
        """
        if not pts.any():
            return
        m = magnitude[pts]
        c1p = magnitude[plus_1[0]][pts[plus_1[1]]]
        c2p = magnitude[plus_2[0]][pts[plus_2[1]]]
        c_plus = c2p * w[pts] + c1p * (1.0 - w[pts]) <= m
        c1m = magnitude[minus_1[0]][pts[minus_1[1]]]
        c2m = magnitude[minus_2[0]][pts[minus_2[1]]]
        c_minus = c2m * w[pts] + c1m * (1.0 - w[pts]) <= m
        local_maxima[pts] = c_plus & c_minus

    s = (slice(None), slice(None))
    sp = (slice(1, None), slice(None))      # rows 1:
    sm = (slice(None, -1), slice(None))     # rows :-1
    cp = (slice(None), slice(1, None))      # cols 1:
    cm = (slice(None), slice(None, -1))     # cols :-1

    same_sign = ((isobel >= 0) & (jsobel >= 0)) | \
                ((isobel <= 0) & (jsobel <= 0))
    diff_sign = ((isobel <= 0) & (jsobel >= 0)) | \
                ((isobel >= 0) & (jsobel <= 0))

    with np.errstate(divide="ignore", invalid="ignore"):
        w_ji = np.where(abs_i > 0, abs_j / np.maximum(abs_i, 1e-300), 0.0)
        w_ij = np.where(abs_j > 0, abs_i / np.maximum(abs_j, 1e-300), 0.0)

    # sector 1: same sign, |di| >= |dj| — gradient ~ (+1, +w)
    pts = eroded_mask & same_sign & (abs_i >= abs_j)
    _sector(pts, w_ji,
            ((sp[0], s[1]), (sm[0], s[1])),        # c1+: (i+1, j)
            ((sp[0], cp[1]), (sm[0], cm[1])),      # c2+: (i+1, j+1)
            ((sm[0], s[1]), (sp[0], s[1])),        # c1-: (i-1, j)
            ((sm[0], cm[1]), (sp[0], cp[1])))      # c2-: (i-1, j-1)

    # sector 2: same sign, |dj| >= |di| — gradient ~ (+w, +1)
    pts = eroded_mask & same_sign & (abs_j >= abs_i)
    _sector(pts, w_ij,
            ((s[0], cp[1]), (s[0], cm[1])),        # c1+: (i, j+1)
            ((sp[0], cp[1]), (sm[0], cm[1])),      # c2+: (i+1, j+1)
            ((s[0], cm[1]), (s[0], cp[1])),        # c1-: (i, j-1)
            ((sm[0], cm[1]), (sp[0], cp[1])))      # c2-: (i-1, j-1)

    # sector 3: diff sign, |dj| >= |di| — gradient ~ (-w, +1)
    pts = eroded_mask & diff_sign & (abs_j >= abs_i)
    _sector(pts, w_ij,
            ((s[0], cp[1]), (s[0], cm[1])),        # c1+: (i, j+1)
            ((sm[0], cp[1]), (sp[0], cm[1])),      # c2+: (i-1, j+1)
            ((s[0], cm[1]), (s[0], cp[1])),        # c1-: (i, j-1)
            ((sp[0], cm[1]), (sm[0], cp[1])))      # c2-: (i+1, j-1)

    # sector 4: diff sign, |di| >= |dj| — gradient ~ (-1, +w)
    pts = eroded_mask & diff_sign & (abs_i >= abs_j)
    _sector(pts, w_ji,
            ((sm[0], s[1]), (sp[0], s[1])),        # c1+: (i-1, j)
            ((sm[0], cp[1]), (sp[0], cm[1])),      # c2+: (i-1, j+1)
            ((sp[0], s[1]), (sm[0], s[1])),        # c1-: (i+1, j)
            ((sp[0], cm[1]), (sm[0], cp[1])))      # c2-: (i+1, j-1)

    # --- hysteresis: 8-connected components of >=low containing >=high ---
    high_mask = local_maxima & (magnitude >= high_threshold)
    low_mask = local_maxima & (magnitude >= low_threshold)
    strel = np.ones((3, 3), bool)
    labels, count = ndimage.label(low_mask, strel)
    if count == 0:
        return low_mask
    sums = ndimage.sum(high_mask, labels,
                       np.arange(count, dtype=np.int32) + 1)
    good_label = np.zeros((count + 1,), bool)
    good_label[1:] = sums > 0
    return good_label[labels]


def compute_depth_boundary_error(edges_gt: np.ndarray, pred: np.ndarray,
                                 mask: Optional[np.ndarray] = None,
                                 low_thresh: float = 0.15,
                                 high_thresh: float = 0.3):
    """Truncated chamfer accuracy/completeness of predicted depth edges
    (`NYUv2/utils.py:122-169`). Returns (dbe_acc, dbe_com, edges_est)."""
    if np.sum(edges_gt) == 0:
        return np.nan, np.nan, np.zeros(pred.shape, dtype=int)

    pred_n = pred.copy().astype("f")
    pred_n[pred_n == 0] = np.nan
    pred_n = pred_n - np.nanmin(pred_n)
    pred_n = pred_n / np.nanmax(pred_n)

    edges_est = canny(np.nan_to_num(pred_n), sigma=np.sqrt(2),
                      low_threshold=low_thresh,
                      high_threshold=high_thresh)

    D_gt = ndimage.distance_transform_edt(1 - edges_gt)
    D_est = ndimage.distance_transform_edt(1 - edges_est)
    max_dist_thr = 10.0

    mask_D_gt = D_gt < max_dist_thr
    E_fin_est_filt = edges_est * mask_D_gt
    if mask is not None:
        E_fin_est_filt = E_fin_est_filt * mask
        D_gt = D_gt * mask

    if np.sum(E_fin_est_filt) == 0:
        return max_dist_thr, max_dist_thr, edges_est

    dbe_acc = np.nansum(D_gt * E_fin_est_filt) / np.nansum(E_fin_est_filt)
    ch1 = np.minimum(D_gt * edges_est, max_dist_thr)
    ch2 = np.minimum(D_est * edges_gt, max_dist_thr)
    dbe_com = (np.nansum(ch1 + ch2)
               / (np.nansum(edges_est) + np.nansum(edges_gt)))
    return dbe_acc, dbe_com, edges_est


def compute_errors_nyu(gt: np.ndarray, pred: np.ndarray):
    """(abs_rel, rmse, log10, a1, a2, a3) — `NYUv2/utils.py:85-98`."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    log10 = np.mean(np.abs(np.log10(gt) - np.log10(pred)))
    return abs_rel, rmse, log10, a1, a2, a3


def _np(t) -> np.ndarray:
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_outputs_pickle(outputs: dict, pred: np.ndarray, save_dir: str,
                        idx: int, use_disparity: bool = False):
    """Per-image wavelet / prediction dump (`NYUv2/utils.py:231-248`).

    The reference pickles ("disp", 0) after `pred_y /= 100` has mutated
    it in place in the metric-depth path (`utils.py:214-218`: `pred_y`
    aliases the output tensor); the disparity path rebinds instead, so
    there the raw decoder output is saved. Kept, as in the JAX package,
    so the dumps compare byte for byte in both modes. Arrays are numpy
    (float32 from the card)."""
    import os
    import pickle
    disp = _np(outputs[("disp", 0)])[0]
    to_save = {("disp", 0): disp if use_disparity else disp / 100.0}
    k = ("wavelets", 2, "LL")
    if k in outputs:
        to_save[k] = _np(outputs[k])[0]
    for scale in range(3):
        for c in ("LH", "HL", "HH"):
            kk = ("wavelets", scale, c)
            if kk in outputs:
                to_save[kk] = _np(outputs[kk])[0, :, :, 0]
    to_save["pred_depth"] = pred
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, f"results_{idx}.pickle"), "wb") as f:
        pickle.dump(to_save, f)


def predict_depth_batch(forward: Callable, rgb_uint8: np.ndarray,
                        use_disparity: bool = False, use_224: bool = False,
                        sparse_threshold: Optional[float] = None,
                        border_crop: int = 16,
                        return_outputs: bool = False, *, device):
    """A batch of eval images (B, H, W, 3) uint8 -> clamped metric depths
    (B, 480, 640) numpy, following `NYUv2/utils.py:183-229` per image:
    every step (resize, the forward with its per-image sparse
    thresholds, the pad / upscale, the clamp) is per image, so a batch
    equals the reference's batch-1 loop.

    forward(image (B, h, w, 3) float32 in [0, 1] on `device`, thresh or
    None) -> the decoder's output dict. The crop is shipped as uint8 and
    cast on `device`."""
    x = rgb_uint8[:, border_crop:-border_crop, border_crop:-border_crop, :]
    x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    x = x.to(torch.float32) / 255.0
    tgt = (224, 224) if use_224 else (480, 640)
    x = resize_bilinear(x, *tgt, align_corners=True)

    out = forward(x, sparse_threshold)
    pred = out[("disp", 0)].float()
    if use_disparity:
        pred = (1000.0 / pred) / 10000.0
    else:
        pred = pred / 100.0

    if not use_224:
        pred = resize_bilinear(pred, 240 - border_crop, 320 - border_crop,
                               align_corners=True)
        pred = pad2d(pred, border_crop // 2, "replicate")
        pred = resize_bilinear(pred, pred.shape[1] * 2, pred.shape[2] * 2,
                               align_corners=True)
    pred_np = torch.clamp(pred, 0.4, 10.0)[..., 0].cpu().numpy()
    if return_outputs:
        return pred_np, out
    return pred_np


def predict_depth(forward: Callable, rgb_uint8: np.ndarray,
                  use_disparity: bool = False, use_224: bool = False,
                  sparse_threshold: Optional[float] = None,
                  border_crop: int = 16,
                  return_outputs: bool = False, *, device):
    """One eval image (H, W, 3) uint8 -> clamped metric depth (480, 640)."""
    res = predict_depth_batch(forward, rgb_uint8[None], use_disparity,
                              use_224, sparse_threshold, border_crop,
                              return_outputs, device=device)
    if return_outputs:
        return res[0][0], res[1]
    return res[0]


def evaluate(forward: Callable, rgbs: np.ndarray, depths: np.ndarray,
             edges_gt: Optional[np.ndarray] = None,
             use_disparity: bool = False, use_224: bool = False,
             sparse_threshold: Optional[float] = None,
             crop=EIGEN_CROP, save_wavelets_dir: Optional[str] = None,
             batch_size: int = 8, *, device,
             timings: Optional[dict] = None):
    """The labeled-set evaluation: the reference's per-image loop
    (`utils.py:306-318`) run in batches of `batch_size` (per-image
    equivalent, see predict_depth_batch); one image at a time when
    wavelets are saved. Returns JAX's dict: abs_rel, rmse, log10, a1-a3,
    and eps_acc / eps_comp with edges (a plain mean, as the reference:
    an image with no GT edge gives NaN, which propagates).

    timings: if given, gets "predict_s" (the batches' predict_depth_batch
    calls, to numpy on the host) and "edges_s" (the host's Canny and
    chamfer distances) added to it."""
    preds = []
    gts = []
    edge_scores = []
    if timings is not None:
        timings.setdefault("predict_s", 0.0)
        timings.setdefault("edges_s", 0.0)
    if use_224 and edges_gt is not None:
        raise ValueError(
            "edge metrics need 480x640 predictions; the reference's "
            "224 path never ran them (shape-incoherent there too)")
    if use_224:
        # GT border-cropped 16 px, then resized to 224x224 (bilinear,
        # align_corners), no Eigen crop (`utils.py:288-291`), aligned
        # with the border-cropped RGB the predictions come from
        gt = torch.from_numpy(np.ascontiguousarray(
            np.asarray(depths, np.float32)[:, 16:-16, 16:-16, None]))
        depths = resize_bilinear(gt, 224, 224,
                                 align_corners=True)[..., 0].numpy()
    bs = 1 if save_wavelets_dir else max(1, batch_size)
    for b0 in range(0, rgbs.shape[0], bs):
        batch = rgbs[b0:b0 + bs]
        t0 = time.perf_counter()
        if save_wavelets_dir:
            pred_b, outs = predict_depth_batch(
                forward, batch, use_disparity, use_224, sparse_threshold,
                return_outputs=True, device=device)
            save_outputs_pickle(outs, pred_b[0], save_wavelets_dir, b0,
                                use_disparity=use_disparity)
        else:
            pred_b = predict_depth_batch(forward, batch, use_disparity,
                                         use_224, sparse_threshold,
                                         device=device)
        t1 = time.perf_counter()
        for j in range(pred_b.shape[0]):
            i = b0 + j
            pred = pred_b[j]
            if not use_224:
                gt = depths[i][crop[0]:crop[1] + 1, crop[2]:crop[3] + 1]
                pc = pred[crop[0]:crop[1] + 1, crop[2]:crop[3] + 1]
            else:
                gt, pc = depths[i], pred
            preds.append(pc)
            gts.append(gt)
            if edges_gt is not None:
                acc, com, _ = compute_depth_boundary_error(
                    edges_gt[i][crop[0]:crop[1] + 1,
                                crop[2]:crop[3] + 1], pc)
                edge_scores.append((acc, com))
        if timings is not None:
            timings["predict_s"] += t1 - t0
            timings["edges_s"] += time.perf_counter() - t1

    pred_all = np.stack(preds)
    gt_all = np.stack(gts)
    abs_rel, rmse, log10, a1, a2, a3 = compute_errors_nyu(gt_all, pred_all)
    result = dict(abs_rel=abs_rel, rmse=rmse, log10=log10,
                  a1=a1, a2=a2, a3=a3)
    if edge_scores:
        es = np.asarray(edge_scores, dtype=np.float64)
        result["eps_acc"] = float(np.mean(es[:, 0]))
        result["eps_comp"] = float(np.mean(es[:, 1]))
    return result


def load_nyu_labeled(mat_path: str, splits_path: str):
    """nyu_depth_v2_labeled.mat (MATLAB v7.3, read with h5py) and the
    official test indices of splits.mat (`evaluate.py:58-68`). Returns
    (rgb uint8 (N, 480, 640, 3), depth float32 (N, 480, 640))."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "reading nyu_depth_v2_labeled.mat needs the h5py package "
            "(the file is MATLAB v7.3, an HDF5 file); it is not "
            "installed") from e
    from scipy import io as sio
    with h5py.File(mat_path, "r") as f:
        rgb = np.asarray(f["images"])      # (N, 3, W, H) in mat order
        depth = np.asarray(f["depths"])    # (N, W, H)
    splits = sio.loadmat(splits_path)
    test_idx = splits["testNdxs"].ravel().astype(int) - 1
    rgb = rgb[test_idx].transpose(0, 3, 2, 1)      # -> (N, 480, 640, 3)
    depth = depth[test_idx].transpose(0, 2, 1)     # -> (N, 480, 640)
    return rgb.astype(np.uint8), depth.astype(np.float32)
