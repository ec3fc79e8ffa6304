"""One rank of tests/test_torch_port_ddp.py's two-rank gloo group on the
CPU (not a test module; the test imports its batch functions too).

Usage: python tests/torch_ddp_worker.py RANK WORLD PORT DIR

Joins the group through `parallel/mesh.initialize_distributed`, then
runs every case on its rows of the global batches that the functions
below make from seeds, and writes DIR/out<RANK>.pt for the parent:
  * kitti, kitti64: ResNet18 + the wavelet decoder at 64x96, global B=4
    (2 rows per rank), stereo + hints, 2 steps in float32 and in float64
    with JAX's automask noise (DIR/inputs.npz): losses, step 1's averaged
    gradients and BN statistics, the parameters after;
  * ratio: one float64 step on a batch whose rank-0 rows carry hints
    nearly everywhere and whose rank-1 rows carry almost none;
  * bf16, nyu_bf16: one mixed-precision step of the kitti and nyu
    cases;
  * bn: one models/resnet.BatchNorm2d in train mode, its outputs, input
    gradients and running statistics;
  * nyu: mobilenet_light + NyuDecoderWave at 64x96, global B=4, 2 float64
    steps;
  * nyu_losses: losses_nyu's SSIM, BerHu and cropped L1 with gradients;
  * helpers: process_shard, multihost_setup's refusals, a disagreeing
    agree_across_processes;
  * cli: tools/train_kitti.main and tools/train_nyu.main with the
    multi-host flags on DIR's mount and zip, then an --auto_resume run.
"""

import os
import sys

import numpy as np
import torch

H, W, N = 64, 96, 4
LR = 1e-4
KITTI = dict(use_stereo=True, frame_ids=(0,), use_depth_hints=True,
             use_wavelets=True, height=H, width=W, batch_size=N,
             weights_init="scratch", learning_rate=LR,
             stereo_warp_kernel="off")
NYU = dict(encoder_type="mobilenet_light", use_wavelets=True,
           pretrained_encoder=False, lr=LR, batch_size=N)
BN_SHAPE = (N, 8, 6, 5)


def rows(tree, rank: int, world: int):
    """This rank's rows of every array of a global batch."""
    n = N // world
    if isinstance(tree, dict):
        return {k: rows(v, rank, world) for k, v in tree.items()}
    return tree[rank * n:(rank + 1) * n]


def kitti_batch(seed: int = 0, few_hints_from: int = N) -> dict:
    """uint8 stereo feed (the device-augment contract of data/kitti.py),
    tests/test_torch_port_train.py's batch at B=4: a textured left view,
    the right view shifted 2-4 px, jitter factors, intrinsics per scale,
    +-0.1 baselines, hints with holes and none in the 8 border columns.
    Rows from `few_hints_from` on keep hints at 1 pixel in 64 only."""
    rs = np.random.RandomState(seed)
    tex = rs.rand(H, W + 8, 3)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    left = np.stack([tex[:, :W], tex[:, 2:W + 2], tex[:, 1:W + 1],
                     tex[:, 3:W + 3]])
    right = np.stack([tex[:, 4:W + 4], tex[:, 0:W], tex[:, 5:W + 5],
                      tex[:, 0:W]])
    batch = {}
    for s in range(4):
        h, w = H // 2 ** s, W // 2 ** s
        small = left.reshape(N, h, 2 ** s, w, 2 ** s, 3).mean(axis=(2, 4))
        batch[("color_u8", "0", s)] = (small * 255).astype(np.uint8)
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
        batch[("K", s)] = np.repeat(k[None], N, 0)
        batch[("inv_K", s)] = np.linalg.pinv(batch[("K", s)]).astype(
            np.float32)
    batch[("color_u8", "s", 0)] = (right * 255).astype(np.uint8)
    batch[("jitter",)] = np.array([[1.1, 0.9, 1.15, 0.05],
                                   [1.0, 1.0, 1.0, 0.0],
                                   [0.9, 1.1, 0.95, -0.05],
                                   [1.05, 1.0, 1.1, 0.02]], np.float32)
    t = np.repeat(np.eye(4, dtype=np.float32)[None], N, 0)
    t[:, 0, 3] = (-0.1, 0.1, 0.1, -0.1)
    batch[("stereo_T",)] = t
    depth = np.full((N, H, W, 1), 0.58 * W * 0.1 / 4.0, np.float32)
    depth *= (1.0 + 0.2 * rs.rand(N, H, W, 1)).astype(np.float32)
    depth[:, ::9, ::7] = 0.0
    depth[:, :, :8] = 0.0
    depth[:, :, -8:] = 0.0
    keep = np.zeros((H, W, 1), bool)
    keep[5::8, 11::8] = True
    depth[few_hints_from:] *= keep
    batch[("depth_hint",)] = depth
    batch[("depth_hint_mask",)] = (depth > 0).astype(np.float32)
    return batch


def conditioned_state(setup):
    """The port's seeded init (the same weights on every call) with the
    wavelet heads' 3x3 convs scaled by 0.1, so no disparity reaches the
    clamp at 0 (tests/test_torch_port_train.py)."""
    state = setup.init_state()
    with torch.no_grad():
        for name, block in state.decoder.blocks.items():
            if "_pos" in name or "_neg" in name:
                block[2].conv.weight.mul_(0.1)
                block[2].conv.bias.mul_(0.1)
    return state


def kitti_setup(**kw):
    from wavelet_monodepth_tpu_torch.parallel import mesh
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import KittiOptions
    return KittiTrainSetup(KittiOptions(**dict(KITTI, **kw), device="cpu",
                                        data_axis=mesh.world_size()),
                           steps_per_epoch=10)


def named(state, attr=None) -> dict:
    out = {}
    for prefix, m in state.modules().items():
        for name, p in m.named_parameters():
            v = p if attr is None else getattr(p, attr)
            if v is not None:
                out[f"{prefix}.{name}"] = v.detach().clone()
    return out


def bn_stats(state) -> dict:
    return {k: v.clone() for k, v in state.encoder.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def kitti_steps(setup, batch: dict, noise: list, rank: int, world: int,
                dtype=torch.float32):
    """The steps of `noise` (one {scale: global (N, H, W, 1) draw} per
    step) on this rank's rows: losses per step, step 1's gradients (as
    Adam took them) and BN statistics, the parameters after. float64:
    the networks, the expanded batch and the noise widened."""
    from wavelet_monodepth_tpu_torch.ops import augment
    state = conditioned_state(setup)
    local = {k: torch.from_numpy(v) for k, v in rows(batch, rank,
                                                     world).items()}
    if dtype == torch.float64:
        for m in state.modules().values():
            m.double()
        local = {k: v.double() if v.is_floating_point() else v
                 for k, v in augment.expand_batch(local).items()}
    out = {"losses": [], "params0": named(state)}
    for i, draw in enumerate(noise):
        losses = setup.train_step(state, local, {
            s: torch.from_numpy(rows(d, rank, world)).to(dtype)
            for s, d in draw.items()})
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if i == 0:
            out["grads"] = named(state, "grad")
            out["stats"] = bn_stats(state)
    out["params"] = named(state)
    out["adam"] = [v.clone() for st in state.optimizer.state.values()
                   for v in st.values() if torch.is_tensor(v)]
    return out


def noise_steps(path: str) -> list:
    """The parent's draws of JAX's automask noise, per step and scale."""
    d = np.load(path)
    steps = sorted({int(k.split("_")[1]) for k in d.files})
    return [{s: d[f"noise_{i}_{s}"] for s in range(4)} for i in steps]


def bn_inputs():
    rs = np.random.RandomState(3)
    x = (rs.randn(*BN_SHAPE) * 2.0 + 0.5).astype(np.float32)
    g = rs.randn(*BN_SHAPE).astype(np.float32)
    affine = rs.randn(4, BN_SHAPE[1]).astype(np.float32)
    return x, g, affine


def bn_case(rank: int, world: int) -> dict:
    """BatchNorm2d in train mode on this rank's rows; the loss is this
    rank's share, sum(y * g), so the input gradient is the global
    loss's."""
    from wavelet_monodepth_tpu_torch.models.resnet import BatchNorm2d
    x, g, affine = bn_inputs()
    bn = BatchNorm2d(BN_SHAPE[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(affine[0]))
        bn.bias.copy_(torch.from_numpy(affine[1]))
        bn.running_mean.copy_(torch.from_numpy(affine[2]))
        bn.running_var.copy_(torch.from_numpy(np.abs(affine[3])))
    bn.train()
    xs = torch.from_numpy(rows(x, rank, world)).requires_grad_()
    y = bn(xs)
    (y * torch.from_numpy(rows(g, rank, world))).sum().backward()
    return {"y": y.detach(), "x_grad": xs.grad, "weight_grad": bn.weight.grad,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def nyu_batch(seed: int = 0):
    """uint8 feed: a smooth image and 8-bit depths (-> 39-1000 cm),
    tests/test_torch_port_nyu_train.py's at B=4."""
    rs = np.random.RandomState(seed)
    tex = rs.rand(N, H, W, 3)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 2)) / 3.0
    depth = rs.randint(10, 256, (N, H // 2, W // 2, 1))
    return (tex * 255).astype(np.uint8), depth.astype(np.uint8)


def nyu_steps(rank: int, world: int, steps: int = 2,
              dtype=torch.float64) -> dict:
    from wavelet_monodepth_tpu_torch.parallel import mesh
    from wavelet_monodepth_tpu_torch.train.nyu import NyuTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import NyuOptions
    setup = NyuTrainSetup(NyuOptions(**NYU, device="cpu",
                                     data_axis=mesh.world_size(),
                                     bfloat16=dtype == torch.bfloat16))
    setup.input_hw, setup.depth_hw = (H, W), (H // 2, W // 2)
    state = setup.init_state(torch.Generator().manual_seed(0))
    image, depth = nyu_batch()
    image = torch.from_numpy(rows(image, rank, world))
    depth = torch.from_numpy(rows(depth, rank, world))
    if dtype == torch.float64:
        from wavelet_monodepth_tpu_torch.ops.augment import expand_nyu
        state.encoder.double()
        state.decoder.double()
        image, depth = (t.double() for t in expand_nyu(image, depth))
    losses = [{k: float(v) for k, v in setup.train_step(
        state, image, depth).items()} for _ in range(steps)]
    return {"losses": losses, "params": named(state),
            "stats": bn_stats(state)}


def nyu_losses_case(rank: int, world: int) -> dict:
    """losses_nyu's three losses and the gradient of their sum."""
    from wavelet_monodepth_tpu_torch.train import losses_nyu
    rs = np.random.RandomState(5)
    pred = rs.rand(N, 16, 20, 1).astype(np.float32)
    target = rs.rand(N, 16, 20, 1).astype(np.float32)
    target[-1] += 2.0                  # BerHu's largest error on rank 1
    p = torch.from_numpy(rows(pred, rank, world)).requires_grad_()
    t = torch.from_numpy(rows(target, rank, world))
    vals = [losses_nyu.ssim_windowed(p, t, 1.0),
            losses_nyu.ssim_windowed(p, t, 1.0, full=True)[1],
            losses_nyu.berhu_loss(p, t), losses_nyu.cropped_l1_loss(p, t)]
    sum(vals).backward()
    return {"values": [float(v.detach()) for v in vals], "grad": p.grad}


def helpers_case() -> dict:
    from wavelet_monodepth_tpu_torch.parallel import mesh
    out = {"shard": mesh.process_shard([f"item{i:02d}" for i in range(11)]),
           "refused": [], "agree": mesh.agree_across_processes(7, "probe")}
    for batch, axis in ((7, 1), (8, 3)):
        try:
            mesh.multihost_setup(batch, axis)
        except SystemExit as e:
            out["refused"].append(str(e))
    out["setup"] = mesh.multihost_setup(8, 1)
    try:
        mesh.agree_across_processes(mesh.rank(), "auto-resume epoch")
    except SystemExit as e:
        out["disagree"] = str(e)
    return out


def cli_case(rank: int, world: int, port: int, tmp: str) -> dict:
    """Both training CLIs with the multi-host flags of this rank, in this
    process (its group is the one they join), then KITTI again with
    --auto_resume for one more epoch."""
    from wavelet_monodepth_tpu_torch.tools import train_kitti, train_nyu
    flags = ["--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", str(world), "--process_id", str(rank),
             "--device", "cpu", "--num_workers", "1"]
    kitti = ["--data_path", os.path.join(tmp, "kitti"), "--split", "tiny",
             "--height", "64", "--width", "96", "--use_stereo",
             "--frame_ids", "0", "--use_depth_hints", "--use_wavelets",
             "--batch_size", "4", "--weights_init", "scratch",
             "--log_frequency", "1", "--log_dir", os.path.join(tmp, "klog"),
             "--model_name", "mh"] + flags
    out = {"kitti": train_kitti.main(kitti + ["--num_epochs", "1"]),
           "kitti_resumed": train_kitti.main(
               kitti + ["--num_epochs", "2", "--auto_resume"])}
    out["nyu"] = train_nyu.main(
        ["--data_path", os.path.join(tmp, "nyu_data.zip"),
         "--encoder_type", "mobilenet_light", "--use_wavelets", "--use_224",
         "--batch_size", "2", "--epochs", "1", "--log_frequency", "1",
         "--no-pretrained_encoder", "--log_dir", os.path.join(tmp, "nlog"),
         "--model_name", "mh"] + flags)
    return out


def main():
    rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from wavelet_monodepth_tpu_torch.parallel import mesh
    assert mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       "cpu")
    mesh.warmup_collectives()
    noise = noise_steps(os.path.join(tmp, "inputs.npz"))
    out = {"rank": rank, "world": mesh.world_size(),
           "helpers": helpers_case(),
           "bn": bn_case(rank, world),
           "nyu_losses": nyu_losses_case(rank, world)}
    out["kitti"] = kitti_steps(kitti_setup(), kitti_batch(), noise, rank,
                               world)
    out["kitti64"] = kitti_steps(kitti_setup(), kitti_batch(), noise, rank,
                                 world, torch.float64)
    out["ratio"] = kitti_steps(kitti_setup(), kitti_batch(few_hints_from=2),
                               noise[:1], rank, world, torch.float64)
    out["bf16"] = kitti_steps(kitti_setup(bfloat16=True), kitti_batch(),
                              noise[:1], rank, world)
    out["nyu"] = nyu_steps(rank, world)
    out["nyu_bf16"] = nyu_steps(rank, world, 1, torch.bfloat16)
    out["cli"] = cli_case(rank, world, port, tmp)
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
