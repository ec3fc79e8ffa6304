"""KITTI training CLI: `KITTI/train.py` and the reference Trainer's epoch
loop (`trainer.py:182-229`), on one card.

Counterpart of `wavelet_monodepth_tpu/tools/train_kitti.py`, with its
flags (`utils/config.py`): threaded item loading, pinned host-to-device
copies, the train step, the reference's log cadence with one-batch
validation on each log step, and per-epoch checkpoints in the reference's
layout. It runs on the card (--device cuda, the default, raises without
one) unless --device cpu is given. --bfloat16 trains in bf16 mixed
precision (`train/kitti.py`); the master parameters, Adam's moments and
the BN statistics stay float32, and so do the checkpoints.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.train_kitti --data_path ... \\
      --use_stereo --frame_ids 0 --use_depth_hints --use_wavelets \\
      --split eigen_full --model_name wavelets_r18 [--stereo_warp_kernel on] \\
      [--bfloat16]
"""

from __future__ import annotations

import os
import time


def main(argv=None, device=None) -> dict:
    """Train; returns {"steps", "val_batches", "losses" (the logged train
    losses), "checkpoints" (folders written)}."""
    import torch

    from ..data import kitti as kitti_data
    from ..data.loader import parallel_batches, to_device
    from ..data.splits import read_split
    from ..train.kitti import KittiTrainSetup
    from ..utils import checkpoint as ckpt
    from ..utils.config import parse_kitti_args
    from ..utils.device import resolve_device
    from ..utils.logging import SummaryLogger, TrainTimer

    opts = parse_kitti_args(argv)
    opts.validate_for_training()
    device = resolve_device(device if device is not None else opts.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log_path = os.path.join(opts.log_dir, opts.model_name)

    train_files = read_split(opts.split, "train_files.txt", opts.data_path)
    val_files = read_split(opts.split, "val_files.txt", opts.data_path)
    # the step reads color_aug only at scale 0 and (without
    # --v1_multiscale) the other frames only at scale 0
    feed_kw = dict(
        is_train=True, img_ext=".png" if opts.png else ".jpg",
        use_depth_hints=opts.use_depth_hints,
        depth_hint_path=opts.depth_hint_path, dataset=opts.dataset,
        aug_scales=(0,),
        other_frame_scales=None if opts.v1_multiscale else (0,),
        device_augment=not opts.host_augment)
    train_ds = kitti_data.KittiRawDataset(
        opts.data_path, train_files, opts.height, opts.width,
        list(opts.all_frame_ids), list(opts.scales), **feed_kw)
    val_ds = kitti_data.KittiRawDataset(
        opts.data_path, val_files, opts.height, opts.width,
        list(opts.all_frame_ids), list(opts.scales),
        **dict(feed_kw, is_train=False))

    steps_per_epoch = len(train_files) // opts.batch_size
    k_steps = opts.steps_per_call
    effective_spe = (steps_per_epoch // k_steps) * k_steps  # drop-last
    setup = KittiTrainSetup(opts, steps_per_epoch=steps_per_epoch,
                            device=device)
    state = setup.init_state(torch.Generator().manual_seed(0))
    noise = torch.Generator(device=device).manual_seed(0)

    start_epoch = opts.start_epoch
    resume_folder = opts.load_weights_folder
    if opts.auto_resume and not resume_folder:
        resume_folder = ckpt.latest_checkpoint(log_path)
        if resume_folder:
            start_epoch = int(os.path.basename(resume_folder)
                              .split("_")[1]) + 1
            print(f"auto-resume: restoring {resume_folder}, "
                  f"continuing at epoch {start_epoch}")
    if resume_folder:
        ckpt.load_checkpoint(resume_folder, state, opts.models_to_load)
    step = start_epoch * effective_spe
    state.step = step

    logger = SummaryLogger(log_path)
    timer = TrainTimer(effective_spe * opts.num_epochs)
    train_src = parallel_batches(train_ds, opts.batch_size,
                                 num_workers=opts.num_workers, shuffle=True)
    val_src = parallel_batches(val_ds, opts.batch_size,
                               num_workers=opts.num_workers, shuffle=True)
    train_iter = to_device(train_src, device)
    val_iter = to_device(val_src, device)

    print(f"Training model named:\n   {opts.model_name}")
    print(f"There are {len(train_files)} training and {len(val_files)} "
          f"validation items")
    summary = {"steps": 0, "val_batches": 0, "losses": [],
               "checkpoints": []}
    try:
        for epoch in range(start_epoch, opts.num_epochs):
            for batch_idx0 in range(0, effective_spe, k_steps):
                durations = {"dataloading": 0.0, "batch_process": 0.0}
                for _ in range(k_steps):
                    t0 = time.time()
                    batch = next(train_iter)
                    t1 = time.time()
                    losses = setup.train_step(state, batch, noise)
                    durations["dataloading"] += t1 - t0
                    durations["batch_process"] += time.time() - t1
                summary["steps"] += k_steps

                # log when the K-step window holds a log boundary
                batch_idx = batch_idx0 + k_steps - 1
                early = any((batch_idx0 + j) % opts.log_frequency == 0
                            for j in range(k_steps)) and (
                                opts.log_always or step + k_steps - 1 < 1000)
                late = any((step + j) % 1000 == 0 for j in range(k_steps))
                if early or late:
                    host = {k: float(v) for k, v in losses.items()}
                    summary["losses"].append(host)
                    print(timer.log_line(epoch, batch_idx,
                                         max(step + k_steps - 1, 1),
                                         opts.batch_size, durations,
                                         host["loss"]))
                    logger.scalars("train", host, step + k_steps - 1)
                    # one-batch validation (`trainer.py:312-327`)
                    _, vlosses = setup.eval_step(state, next(val_iter),
                                                 noise)
                    summary["val_batches"] += 1
                    logger.scalars("val",
                                   {k: float(v) for k, v in vlosses.items()},
                                   step + k_steps - 1)
                step += k_steps

            if (epoch + 1) % opts.save_frequency == 0:
                folder = ckpt.save_checkpoint(log_path, epoch, state, opts)
                summary["checkpoints"].append(folder)
                print(f"saved checkpoint to {folder}")
    finally:
        train_iter.close()
        val_iter.close()
        train_src.close()
        val_src.close()
        logger.close()
    return summary


if __name__ == "__main__":
    main()
