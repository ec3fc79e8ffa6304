"""NYUv2 training CLI: `NYUv2/train.py:165-352`, on one card or
data-parallel over several.

Counterpart of `wavelet_monodepth_tpu/tools/train_nyu.py`, with its flags
(`utils/config.parse_nyu_args`) plus --device: the zip in memory
(`data/nyu.py`), threaded item loading and pinned host-to-device copies
(`data/loader.py`), the train step (`train/nyu.py`), the reference's
print every 5 steps, and at every `log_frequency`-th step the train
losses and one validation batch's losses, drawn from the "test" dataset
(the same nyu2_train rows with the test transform, as in the reference),
as TensorBoard scalars, with the reference's visuals of both batches
(`NYUv2/train.py:113-163`: colour, GT and predicted disparities, and
under --use_wavelets the predicted and GT coefficients, the GT from
`haar_dwt_J(depth_n, 4)`, as images and histograms). The train batch is
forwarded once more through the eval step for them, only when there is
a train writer, without gradients, on the BN running statistics. Per epoch it writes
`<log_dir>/<model_name>/models/weights_<epoch>/{model,adam}.pth` and
`models/opt.json` (`utils/checkpoint.py`), which
`tools/evaluate_nyu.py --load_weights_folder` reads;
`--auto_resume` continues after the newest complete folder and
`--load_weights_folder` restores one. It runs on the card (--device cuda,
the default, raises without one) unless --device cpu is given;
--bfloat16 trains in JAX's mixed precision (`train/nyu.py`), and the
checkpoints stay float32.

Data parallelism follows JAX's wiring (`parallel/mesh.py`), as in
`tools/train_kitti.py`: one command per host; `--data_axis N` starts N
ranks on one host, the multi-host flags one rank per visible card on
each host (one with --device cpu). Each rank keeps its interleaved shard
of the pair lists and feeds batch_size / ranks rows; the step is the
global batch's (`train/nyu.py`); rank 0 prints, logs and writes the
checkpoints; --auto_resume agrees on the epoch across ranks. A rank
that fails makes the command exit non-zero.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.train_nyu --data_path \\
      nyu_data.zip --use_wavelets --encoder_type densenet [--bfloat16]
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
    from ..utils.config import parse_nyu_args

    argv = list(sys.argv[1:] if argv is None else argv)
    opts = parse_nyu_args(argv)
    device = device_rule.resolve_device(device if device is not None
                                        else opts.device)
    ranks = mesh_lib.local_rank_count(opts, device)
    if ranks > 1:
        return mesh_lib.launch_local_ranks(
            "wavelet_monodepth_tpu_torch.tools.train_nyu", argv, opts,
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

    from ..data import nyu as nyu_data
    from ..data.loader import parallel_batches, to_device
    from ..ops.augment import expand_nyu
    from ..ops.wavelets import haar_dwt_J
    from ..parallel import mesh as mesh_lib
    from ..train.nyu import NyuTrainSetup
    from ..utils import checkpoint as ckpt
    from ..utils.logging import SummaryLogger

    log_path = os.path.join(opts.log_dir, opts.model_name)
    is_main = mesh_lib.is_main()
    train_ds, test_ds = nyu_data.get_training_testing_data(
        opts.data_path, is_224=opts.use_224, uint8_feed=not opts.float_feed)
    n_train = len(train_ds)
    local_batch, opts.data_axis = mesh_lib.multihost_setup(
        opts.batch_size, opts.data_axis)
    train_ds.pairs = mesh_lib.process_shard(train_ds.pairs)
    test_ds.pairs = mesh_lib.process_shard(test_ds.pairs)
    mesh_lib.warmup_collectives()
    setup = NyuTrainSetup(opts, device=device)
    state = setup.init_state(torch.Generator().manual_seed(0))
    start_epoch = 0
    resume_folder = opts.load_weights_folder
    if opts.auto_resume and not resume_folder:
        resume_folder = ckpt.latest_checkpoint(log_path, ckpt.NYU_FILES)
        if resume_folder:
            start_epoch = int(os.path.basename(resume_folder)
                              .split("_")[1]) + 1
            print(f"auto-resume: restoring {resume_folder}, "
                  f"continuing at epoch {start_epoch}")
        # every rank must resolve the same epoch (a shared log_dir)
        start_epoch = mesh_lib.agree_across_processes(
            start_epoch, "auto-resume epoch")
    if resume_folder:
        ckpt.load_nyu_checkpoint(resume_folder, state)

    n_batches = n_train // opts.batch_size
    step = start_epoch * n_batches
    state.step = step
    if not is_main:
        logger = SummaryLogger(log_path, writers={})
    elif logger is None:
        logger = SummaryLogger(log_path)

    def gt_wavelets(depth_n):
        return haar_dwt_J(depth_n, 4) if opts.use_wavelets else None
    train_src = parallel_batches(train_ds, local_batch,
                                 num_workers=opts.num_workers)
    val_src = parallel_batches(test_ds, local_batch,
                               num_workers=opts.num_workers, shuffle=False)
    train_iter = to_device(train_src, device)
    val_iter = to_device(val_src, device)
    summary = {"steps": 0, "val_batches": 0, "losses": [],
               "val_losses": [], "checkpoints": []}
    try:
        for epoch in range(start_epoch, opts.epochs):
            t_end = time.time()
            for i in range(n_batches):
                batch = next(train_iter)
                losses = setup.train_step(state, batch["image"],
                                          batch["depth"])
                summary["steps"] += 1
                if i % 5 == 0 and is_main:
                    print(f"Epoch: [{epoch}][{i}/{n_batches}]\t"
                          f"Time {time.time() - t_end:.3f}\t "
                          f"Loss {float(losses['loss']):.4f}")
                if i % opts.log_frequency == 0:
                    host = {k: float(v) for k, v in losses.items()}
                    summary["losses"].append(host)
                    logger.scalars("train", host, step)
                    if logger.active("train"):
                        # eval mode: no collective, so rank 0 alone
                        img_f, dep_f = expand_nyu(batch["image"],
                                                  batch["depth"])
                        depth_n = setup.targets(dep_f)
                        logger.log_nyu_visuals(
                            "train", img_f, depth_n,
                            setup.eval_step(state, batch["image"]),
                            gt_wavelets(depth_n), step)
                    vbatch = next(val_iter)
                    outputs = setup.eval_step(state, vbatch["image"])
                    vimg_f, vdepth = expand_nyu(vbatch["image"],
                                                vbatch["depth"])
                    vdepth_n = setup.targets(vdepth)
                    vlosses = {k: float(v) for k, v in setup.compute_losses(
                        outputs, vdepth_n).items()}
                    summary["val_batches"] += 1
                    summary["val_losses"].append(vlosses)
                    logger.scalars("val", vlosses, step)
                    logger.log_nyu_visuals("val", vimg_f, vdepth_n, outputs,
                                           gt_wavelets(vdepth_n), step)
                t_end = time.time()
                step += 1
            folder = ckpt.save_nyu_checkpoint(log_path, epoch, state, opts)
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
