"""KITTI eigen-split evaluation CLI: the port's `KITTI/evaluate_depth.py`.

Counterpart of `wavelet_monodepth_tpu/tools/evaluate_depth.py`, with its
flags. Loads weights (--torch_model_path: a reference folder;
--load_weights_folder: the port's own checkpoint folder, which has the
same encoder.pth / depth.pth layout), predicts disparities over the eval
split (dense, with --post_process the flip fusion; --use_sparse
--threshold T: sparse, with densities and op counts), scores them
against the split's gt_depths.npz and prints the seven-metric row.
--bfloat16 casts the model whole (`utils/precision.py`). The decoder
runs its default sparse backend (masked dense), as in the JAX package.
Without --use_wavelets the folder holds the baseline DepthDecoder
(monodepth2's, `models/decoders_kitti.DepthDecoder`), always dense.

The feed ships uint8 frames, which the forward scales on the card;
--host_augment ships float32 instead. --native_decode decodes and
resizes each batch in one call to the repo's threaded C++ decoder
(`data/native_loader.py`: OpenCV's LANCZOS4, about 1e-3 per pixel from
the PIL feed's LANCZOS) on max(1, --num_workers) threads; it raises when
that library cannot be built, and never falls back to PIL. Runs on
--device (cuda, which raises without a card, or cpu).

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.evaluate_depth \
      --data_path ROOT --torch_model_path WEIGHTS --eval_stereo \
      --use_wavelets [--use_sparse --threshold 0.1] [--post_process] \
      [--bfloat16] [--native_decode] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    """(KittiOptions, torch_model_path): the KITTI options, and
    --torch_model_path, which the KITTI options lack (the JAX package
    reads it from WMD_TORCH_MODEL_PATH only; so does this CLI when the
    flag is not given)."""
    from ..utils.config import parse_kitti_args
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--torch_model_path", type=str, default=None)
    ns, rest = pre.parse_known_args(argv)
    return (parse_kitti_args(rest),
            ns.torch_model_path or os.environ.get("WMD_TORCH_MODEL_PATH"))


def load_forward(opts, device, torch_model_path=None):
    """The model's forward from `torch_model_path` (a reference folder) or
    else --load_weights_folder, on `device`, in eval mode. forward(image
    (N, H, W, 3) uint8 or float tensor on `device`, thresh or None) ->
    the decoder's output dict, float32 also under --bfloat16."""
    from ..models.factory import make_depth_decoder, make_depth_encoder
    from ..utils.precision import cast_floats, wrap_forward_bf16
    from . import torch_import as ti

    folder = torch_model_path or opts.load_weights_folder
    if not folder:
        raise SystemExit("pass --torch_model_path (a reference folder) or "
                         "--load_weights_folder (a checkpoint folder of "
                         "the port): encoder.pth and depth.pth")
    encoder, num_ch_enc = make_depth_encoder(opts)
    decoder = make_depth_decoder(num_ch_enc, opts)
    ti.load_state_dicts(encoder, decoder,
                        *ti.load_reference_checkpoint(folder))
    encoder.to(device).eval()
    decoder.to(device).eval()
    bf16 = opts.bfloat16
    if bf16:
        cast_floats(encoder, torch.bfloat16)
        cast_floats(decoder, torch.bfloat16)

    @torch.inference_mode()
    def forward(image: torch.Tensor, thresh=None):
        if image.dtype == torch.uint8:
            image = image.to(torch.float32) / 255.0
            if bf16:
                image = image.to(torch.bfloat16)
        feats = encoder(image)
        if thresh is None:
            return decoder(feats)
        return decoder(feats, thresh_ratio=thresh)

    return wrap_forward_bf16(forward) if bf16 else forward


def eval_dataset(opts, files):
    """The eval split's dataset: scale 0 of frame 0 only, uint8 unless
    --host_augment."""
    from ..data.kitti import KittiRawDataset
    return KittiRawDataset(
        opts.data_path, files, opts.height, opts.width, [0],
        target_scales=[0], is_train=False,
        img_ext=".png" if opts.png else ".jpg",
        device_augment=not opts.host_augment)


def eval_batch_size(opts) -> int:
    """--batch_size, or 1 when coefficients are saved (the reference
    saves per image)."""
    coeff_mode = opts.save_pred_disps and opts.use_wavelets
    return 1 if coeff_mode else max(1, opts.batch_size)


def eval_batches(opts, ds):
    """Numpy batches of the eval images through the dataset's PIL feed."""
    bs = eval_batch_size(opts)
    key = ("color", "0", 0) if opts.host_augment else ("color_u8", "0", 0)
    buf = []
    for i in range(len(ds)):
        buf.append(ds[i][key])
        if len(buf) == bs:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def native_batches(opts, ds, files):
    """Numpy batches of the eval images through the native decoder: one
    call per batch on max(1, --num_workers) threads, uint8 unless
    --host_augment (`tools/evaluate_depth.py:113-131` of the JAX
    package)."""
    from ..data import native_loader as nl
    paths = []
    for line in files:
        parts = line.split()
        frame, side = ((int(parts[1]), parts[2]) if len(parts) == 3
                       else (0, None))
        paths.append(ds.get_image_path(parts[0], frame, side))
    decode = (nl.decode_resize_batch if opts.host_augment
              else nl.decode_resize_batch_u8)
    bs = eval_batch_size(opts)
    for b0 in range(0, len(paths), bs):
        yield decode(paths[b0:b0 + bs], opts.height, opts.width,
                     num_threads=max(1, opts.num_workers))


def save_benchmark_pngs(pred_disps: np.ndarray, save_dir: str) -> None:
    """The KITTI online benchmark's 16-bit PNGs of depth * 256 at 1216x352
    (`evaluate_depth.py:241-256`)."""
    from PIL import Image
    from ..eval.kitti_eval import STEREO_SCALE_FACTOR
    from ..ops.resize import resize_linear
    os.makedirs(save_dir, exist_ok=True)
    for idx in range(len(pred_disps)):
        disp = resize_linear(pred_disps[idx], 1216, 352)
        depth = np.clip(STEREO_SCALE_FACTOR / disp, 0, 80)
        Image.fromarray(np.uint16(depth * 256)).save(
            os.path.join(save_dir, f"{idx:010d}.png"))


def main(argv=None):
    from ..data.splits import readlines, resolve_split_dir
    from ..eval import kitti_eval
    from ..utils import device as device_rule

    opts, torch_model_path = parse_args(argv)
    if int(opts.eval_mono) + int(opts.eval_stereo) != 1:
        raise ValueError("choose --eval_mono or --eval_stereo")
    if opts.native_decode and opts.ext_disp_to_eval is None:
        from ..data import native_loader
        native_loader.load_library()    # raises naming what is missing
    device = device_rule.resolve_device(opts.device)
    device_rule.pin_float32(device)
    split_dir = resolve_split_dir(opts.eval_split, opts.data_path)

    info = None
    if opts.ext_disp_to_eval is None:
        files = readlines(os.path.join(split_dir, "test_files.txt"))
        forward = load_forward(opts, device, torch_model_path)
        thresh = opts.threshold if (opts.use_sparse
                                    and opts.use_wavelets) else None
        ds = eval_dataset(opts, files)
        batches = (native_batches(opts, ds, files) if opts.native_decode
                   else eval_batches(opts, ds))
        pred_disps, info = kitti_eval.predict_disps(
            forward, batches,
            device=device, min_depth=opts.min_depth,
            max_depth=opts.max_depth, post_process=opts.post_process,
            sparse_threshold=thresh,
            collect_coeffs=opts.save_pred_disps and opts.use_wavelets)
        if "total_ops_mean" in info:
            print(f"total_ops: mean {info['total_ops_mean'] / 1e9:2.3f} "
                  f"GFLOPs, density: {100 * info['density_mean']:.3f}%")
    else:
        print(f"-> Loading predictions from {opts.ext_disp_to_eval}")
        pred_disps = np.load(opts.ext_disp_to_eval)

    if opts.save_pred_disps and opts.load_weights_folder:
        np.save(os.path.join(opts.load_weights_folder,
                             f"disps_{opts.eval_split}_split.npy"), pred_disps)
        # per-scale 4-coefficient stacks (`evaluate_depth.py:231-235`)
        for s, arr in (info or {}).get("coeffs", {}).items():
            np.save(os.path.join(
                opts.load_weights_folder,
                f"disps_coeffs_s{s}_{opts.eval_split}_split.npy"), arr)

    if opts.no_eval:
        print("-> Evaluation disabled. Done.")
        return None

    if opts.eval_split == "benchmark":
        save_dir = os.path.join(opts.load_weights_folder or ".",
                                "benchmark_predictions")
        save_benchmark_pngs(pred_disps, save_dir)
        print(f"-> Saved benchmark predictions to {save_dir}; no GT "
              "available, not evaluating. Done.")
        return None

    gt_depths = np.load(os.path.join(split_dir, "gt_depths.npz"),
                        fix_imports=True, encoding="latin1",
                        allow_pickle=True)["data"]
    mean_errors, ratios = kitti_eval.evaluate_disps(
        pred_disps, gt_depths, eval_split=opts.eval_split,
        eval_stereo=opts.eval_stereo,
        disable_median_scaling=opts.disable_median_scaling,
        pred_depth_scale_factor=opts.pred_depth_scale_factor)
    if len(ratios):
        med = np.median(ratios)
        print(f" Scaling ratios | med: {med:0.3f} | "
              f"std: {np.std(ratios / med):0.3f}")
    print(kitti_eval.format_result_table(mean_errors))
    print("\n-> Done!")
    return {"metrics": dict(zip(
        ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"),
        (float(v) for v in mean_errors))),
        "ratios": np.asarray(ratios),
        "density_mean": (info or {}).get("density_mean"),
        "total_ops_mean": (info or {}).get("total_ops_mean")}


if __name__ == "__main__":
    main()
