"""KITTI training CLI: `KITTI/train.py` and the reference Trainer's epoch
loop (`trainer.py:182-229`), on one card or data-parallel over several.

Counterpart of `wavelet_monodepth_tpu/tools/train_kitti.py`, with its
flags (`utils/config.py`): threaded item loading, pinned host-to-device
copies, the train step, the reference's log cadence with one-batch
validation on each log step, and per-epoch checkpoints in the reference's
layout. Each log step also writes the reference's visuals
(`trainer.py:661-720`) of the train batch, forwarded once more through
the eval step, and of the validation batch. That extra forward runs only
when there is a train writer, without gradients, on the BN running
statistics, with its own noise generator, so the training run (weights,
BN statistics, Adam, the noise stream) is the same with or without it. It runs on the card (--device cuda, the default, raises without
one) unless --device cpu is given. --bfloat16 trains in bf16 mixed
precision (`train/kitti.py`); the master parameters, Adam's moments and
the BN statistics stay float32, and so do the checkpoints.

Data parallelism follows JAX's wiring (`parallel/mesh.py`): one command
per host. `--data_axis N` on one host starts N ranks, one per visible
card (ranks share cards when there are fewer; then they run on gloo);
with `--coordinator_address HOST:PORT --num_processes P --process_id p`
each host starts one rank per visible card (one with --device cpu). Each
rank feeds batch_size / ranks rows of its interleaved shard of the split;
the step is the global batch's (`train/kitti.py`); rank 0 prints, logs
and writes the checkpoints, and every rank resumes from them
(--auto_resume agrees on the epoch). A rank that fails makes the command
exit non-zero.

Monocular and mono+stereo runs (--frame_ids 0 -1 1, with or without
--use_stereo) train the pose networks beside the depth model
(--pose_model_type separate_resnet | posecnn, --pose_model_input pairs |
all); the loader reads each line's neighbouring frames k-1 and k+1.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.train_kitti --data_path ... \\
      --use_stereo --frame_ids 0 --use_depth_hints --use_wavelets \\
      --split eigen_full --model_name wavelets_r18 [--stereo_warp_kernel on] \\
      [--bfloat16]
  python -m wavelet_monodepth_tpu_torch.tools.train_kitti --data_path ... \\
      --use_stereo --frame_ids 0 -1 1 --use_depth_hints --use_wavelets \\
      --split eigen_zhou --model_name ms_r18
  python -m wavelet_monodepth_tpu_torch.tools.train_kitti --data_path ... \\
      --use_stereo --frame_ids 0 --use_depth_hints --use_wavelets \\
      --data_axis 4
"""

from __future__ import annotations

import os
import time


def main(argv=None, device=None, logger=None) -> dict:
    """Train; returns {"steps", "val_batches", "losses" (the logged train
    losses), "val_losses", "checkpoints" (folders written)}, rank 0's
    when this command starts ranks. logger: a SummaryLogger in place of
    the tensorboardX one under log_dir/model_name (rank 0's: the other
    ranks log nothing)."""
    import sys

    from ..parallel import mesh as mesh_lib
    from ..utils import device as device_rule
    from ..utils.config import parse_kitti_args

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_kitti_args(argv)
    opts.validate_for_training()
    device = device_rule.resolve_device(device if device is not None
                                        else opts.device)
    ranks = mesh_lib.local_rank_count(opts, device)
    if ranks > 1:
        return mesh_lib.launch_local_ranks(
            "wavelet_monodepth_tpu_torch.tools.train_kitti", argv, opts,
            device, ranks)
    device_rule.pin_float32(device)
    owns_group = mesh_lib.initialize_distributed(
        opts.coordinator_address, opts.num_processes, opts.process_id,
        device)
    try:
        return _train(opts, device, logger)
    finally:
        if owns_group:
            mesh_lib.shutdown()


def _train(opts, device, logger) -> dict:
    """One rank's run (the only one's without a process group)."""
    import torch

    from ..data import kitti as kitti_data
    from ..data.loader import parallel_batches, to_device
    from ..data.splits import read_split
    from ..parallel import mesh as mesh_lib
    from ..train.kitti import KittiTrainSetup
    from ..utils import checkpoint as ckpt
    from ..utils.logging import SummaryLogger, TrainTimer

    log_path = os.path.join(opts.log_dir, opts.model_name)
    is_main = mesh_lib.is_main()
    train_files = read_split(opts.split, "train_files.txt", opts.data_path)
    val_files = read_split(opts.split, "val_files.txt", opts.data_path)
    # global sizes set the (lockstep) step counts; each rank loads
    # batch_size / ranks items of its own shard per step
    n_train, n_val = len(train_files), len(val_files)
    local_batch, opts.data_axis = mesh_lib.multihost_setup(
        opts.batch_size, opts.data_axis)
    train_files = mesh_lib.process_shard(train_files)
    val_files = mesh_lib.process_shard(val_files)
    mesh_lib.warmup_collectives()
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

    steps_per_epoch = n_train // opts.batch_size
    k_steps = opts.steps_per_call
    effective_spe = (steps_per_epoch // k_steps) * k_steps  # drop-last
    setup = KittiTrainSetup(opts, steps_per_epoch=steps_per_epoch,
                            device=device)
    state = setup.init_state(torch.Generator().manual_seed(0))
    noise = torch.Generator(device=device).manual_seed(0)
    vis_noise = torch.Generator(device=device).manual_seed(1)

    start_epoch = opts.start_epoch
    resume_folder = opts.load_weights_folder
    if opts.auto_resume and not resume_folder:
        resume_folder = ckpt.latest_checkpoint(
            log_path, ckpt.checkpoint_files(state))
        if resume_folder:
            start_epoch = int(os.path.basename(resume_folder)
                              .split("_")[1]) + 1
            print(f"auto-resume: restoring {resume_folder}, "
                  f"continuing at epoch {start_epoch}")
        # every rank must resolve the same epoch (a shared log_dir), or
        # their step counts part inside a collective
        start_epoch = mesh_lib.agree_across_processes(
            start_epoch, "auto-resume epoch")
    if resume_folder:
        ckpt.load_checkpoint(resume_folder, state, opts.models_to_load)
    step = start_epoch * effective_spe
    state.step = step

    if not is_main:
        logger = SummaryLogger(log_path, writers={})
    elif logger is None:
        logger = SummaryLogger(log_path)
    # the train visuals' forward runs the losses' collectives: every rank
    # runs it when rank 0 logs them
    train_visuals = mesh_lib.broadcast_flag(logger.active("train"))
    timer = TrainTimer(effective_spe * opts.num_epochs)
    train_src = parallel_batches(train_ds, local_batch,
                                 num_workers=opts.num_workers, shuffle=True)
    val_src = parallel_batches(val_ds, local_batch,
                               num_workers=opts.num_workers, shuffle=True)
    train_iter = to_device(train_src, device)
    val_iter = to_device(val_src, device)

    if is_main:
        print(f"Training model named:\n   {opts.model_name}")
        print(f"There are {n_train} training and {n_val} validation items")
    summary = {"steps": 0, "val_batches": 0, "losses": [],
               "val_losses": [], "checkpoints": []}
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
                    if is_main:
                        print(timer.log_line(epoch, batch_idx,
                                             max(step + k_steps - 1, 1),
                                             opts.batch_size, durations,
                                             host["loss"]))
                    logger.scalars("train", host, step + k_steps - 1)
                    if train_visuals:
                        toutputs, _ = setup.eval_step(state, batch,
                                                      vis_noise)
                        logger.log_kitti_visuals("train", batch, toutputs,
                                                 opts, step + k_steps - 1)
                        del toutputs
                    # one-batch validation (`trainer.py:312-327`)
                    vbatch = next(val_iter)
                    voutputs, vlosses = setup.eval_step(state, vbatch, noise)
                    vhost = {k: float(v) for k, v in vlosses.items()}
                    summary["val_batches"] += 1
                    summary["val_losses"].append(vhost)
                    logger.scalars("val", vhost, step + k_steps - 1)
                    logger.log_kitti_visuals("val", vbatch, voutputs, opts,
                                             step + k_steps - 1)
                    del voutputs
                step += k_steps

            if (epoch + 1) % opts.save_frequency == 0:
                folder = ckpt.save_checkpoint(log_path, epoch, state, opts)
                summary["checkpoints"].append(folder)
                if is_main:
                    print(f"saved checkpoint to {folder}")
    finally:
        train_iter.close()
        val_iter.close()
        train_src.close()
        val_src.close()
        logger.close()
    return summary


if __name__ == "__main__":
    from ..parallel.mesh import write_rank_result
    write_rank_result(main())
