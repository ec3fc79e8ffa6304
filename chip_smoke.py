#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Drives wavelet_monodepth_tpu_torch's paths at full width (KITTI
ResNet18, 640x192, random weights from seeded torch.Generators): serving
(dense and sparse inference on every sparse backend: the tile-sparse 3x3
conv kernel, the block IO kernels of the compact backend), training
(stereo + depth hints at batch 12 with the banded warp kernel), the
eigen-split evaluation (ResNet18 640x192 and ResNet50 1024x320) and the
NYUv2 serving and evaluation path (DenseNet161 + the wavelet decoder at
640x480), plus the fused wave stage kernel on the serving slice's own
stage inputs, in phases; any failure raises and exits non-zero:

  1. device: needs CUDA (raises otherwise), turns TF32 off, prints the
     card's name and power limit;
  2. build: the four csrc/*.cu sources, one nvcc each, started together;
     prints each one's ptxas registers and spills;
  3. conv kernel vs plain: both wrappers (stripe flags, K1; 2-D tile
     flags, K4) against the plain PyTorch version at every decoder conv
     shape of the path at B=1 and B=16 (ResNet18 at 640x192 and ResNet50
     at 1024x320, whose skips widen upconv_3_1 / upconv_2_1 to Cin 640 /
     320), plus all pad modes / epilogues and
     all-zero, all-one and ragged masks; max |err| <= 1e-4;
  4. serving: a reference-layout checkpoint folder and 4 scene PNGs are
     written to a temp dir, and servers built by tools/infer.load_model
     answer each image with --use_sparse --threshold 0.1 on the kernel
     backends (12 conv launches per request each) and the compacted ones
     ("compact": 18 band_gather + 6 block_scatter launches per request;
     "sites", "capacity"; compact_cap 0.5), all counted; answers are
     checked against the masked-dense cuDNN backend where the backend is
     exact and nothing overflowed; then tools/infer.main runs once;
  5. serving contracts: thresh=-1 sparse == dense (bitwise on the xla
     backend, 1e-4 on the kernel backends) and, at bench.py's operating
     point (B=16, 10% edge masks via mask_override), kernel backends ==
     xla within 1e-4 with equal op counts; the compacted backends at
     compact_cap 1.0 overflow nowhere, keep xla's op counts and equal xla
     within 1e-4 (sites, capacity: whole tensors; compact: away from its
     image-border ring, COMPACT_RING); at 0.5 their overflow is printed;
     one ResNet50 1024x320 B=1 request on pallas, pallas2d and compact
     (compact_cap 1.0) under the same contracts, its launches counted;
  5a. bf16 serving: servers from tools/infer.load_model(--bfloat16) on
     xla, compact, sites and capacity (compact_cap 1.0) answer B=16 and
     B=1 requests at the 10% maskgen point (the bf16 path: K5/K6's bf16
     instances, 18 + 6 launches per request on compact, counted from 0):
     disp within max 0.05 / mean 0.01 of the float32 server's of the
     same backend, op counts equal to xla bf16's, no overflow, within the
     same bounds of xla bf16 (compact: away from its ring); pallas and
     pallas2d raise in bf16 (JAX cannot lower them);
  5b. block IO vs plain, float32 and bf16: the 18 gathers and 6 scatters
     of a compact forward at B=16 and B=1, every tile of a stack
     (window_h == th, the last row block) and odd C=1 / C=3 row widths;
     bitwise equal; then the synchronising calls of one B=16 compact
     forward (float32, compact_cap 1.0) under
     torch.cuda.set_sync_debug_mode("warn"), none of them block_scatter's;
     after every phase that scatters, the scatter kernel's fault counter
     (block IO's scatter_faults) must read 0;
  5c. fused wave stage (K2) vs plain (<= 1e-4) and vs the masked-dense
     oracle's interior (2 px for yh and x1, 4 px for yl_new; <= 1e-4) on
     the decoder's stage inputs at scales 3, 2, 1, B=16 and B=1, under
     the 10% maskgen, all-zero and all-one masks;
  6. serving times (CUDA events, warm-up, median of 3 interleaved windows
     with min and max): per-conv kernel vs plain vs cuDNN's F.conv2d with
     each conv's bound at float32 accuracy (3xTF32 tensor rate or bytes)
     and at the f32 CUDA-core rate, the share of active stripe and (8, 64)
     tile granules, the FLOPs over them and each wrapper's rate on them;
     whole forward dense vs sparse xla / pallas /
     pallas2d / compact / sites / capacity (compact_cap 0.5, and 1.0 for
     compact and capacity) at B=16 and B=1; K5 and K6 (each with its
     output's allocation) summed over one B=16 compact forward's
     launches, float32 and bf16;
     K2 per scale at B=16 and B=1, its bound at the 3xTF32 and the f32
     CUDA-core rates; a torch.profiler trace of the compacted backends'
     B=16 forwards and of dense and sparse xla in float32 and bf16
     (device idle share, costliest kernels and ATen ops);
  6b. the bench twin: tools/bench.py's cells (bench.py's keys: dense and
     sparse x float32 and bf16 at B=16, the threshold cell, B=1 bf16,
     density, FLOPs; extra rows for the kernel and compacted backends),
     re-emitted as {"phase": "bench", ...};
  7. warp kernel vs plain: the banded warp (K3) forward and its gradients
     for src, x and yr, with and without the source-row pass, on the
     path's (12, 192, 640, 3) stereo grids (a random net's depth and
     maskgen scenes, stereo_T[0, 3] = +-0.1), a border clamp and ragged
     small shapes; forward <= 1e-5, gradients <= 1e-4 of their largest
     value; the path's grids must be row-banded (|y - row| <= 1);
  8. training: a KITTI-layout mount (36 stereo pairs at 1242x375 JPEG
     from maskgen scenes, depth hints, a split) in a temp dir, then
     tools/train_kitti.main for one epoch at B=12 with
     --stereo_warp_kernel on: 3 steps, one validation batch, 5 forward
     and 4 backward K3 launches per step (5 more forward for the
     validation batch), finite losses, the checkpoint folder, which
     tools/infer then serves; then the same with --bfloat16 (mixed
     precision), whose checkpoint holds only float32 tensors;
  9. training contracts: "on" vs "off" on one batch and one set of
     weights: without hints and automasking (no argmin) losses within
     1e-5 and every gradient within 1e-3 of its norm; with them (the
     flagship, whose argmins flip where the two warps differ by ~1e-5)
     <= 0.5% of the mask pixels flipped and losses within 1e-4
     relative; one step launches K3 exactly 5 + 4 times; and the hint
     loss of a 640x192 B=4 batch falls by >= 15% in 30 steps, in float32
     and in bf16 mixed precision (parameters, BN buffers and Adam moments
     float32 after the steps);
 10. training times: ms per train step at B=12, "on" vs "auto" vs "on"
     in bf16 mixed precision, data on the card; a torch.profiler trace
     of each (device idle share) and one of an "on" step with input
     shapes (device time by ATen op); its costliest op, a decoder conv,
     alone (B=12 and B=16, cuDNN's heuristic vs benchmark); K3
     forward (alone and after its torch coordinate chain) and backward
     per launch against the plain version, F.grid_sample and their
     bound;
 11. eval: a synthetic eigen mount (data/synth.py, 16 test frames at
     1242x375 JPEG with exact GT) and tools/evaluate_depth.main with
     --eval_stereo: ResNet18 640x192 on phase 8's checkpoint, (a) dense
     --post_process (also on the CPU), (b) --use_sparse --threshold 0.1
     --post_process, (c) --bfloat16 --post_process, (d)
     --ext_disp_to_eval of (a)'s saved disparities; ResNet50 1024x320 on
     seeded weights, dense and sparse. Finite rows, (d) == (a), card vs
     CPU within 1e-4 (disparities and row), (b)'s ops == the decoder's
     own, (c) within the bf16 bounds of (a); per run the row, density,
     GFLOPs per image, seconds, and predict_disps' frames/s and host-feed
     share, the B=12 forward alone (CUDA events, a profile, and under
     cudnn.benchmark for comparison). The eval runs the masked-dense
     decoder, as in the JAX package: no kernel of the repo is on it;
 12. nyu: 16 synthetic labeled frames (data/synth.render_scene's view
     resized to 640x480, its true depth x0.25, GT edges from
     nyu_eval.canny) and a seeded DenseNet161 + NyuDecoderWave written as
     a reference model.pth, read by tools/evaluate_nyu.load_forward;
     nyu_eval.evaluate (batches of 8, edges) (a) dense, (b) dense on the
     CPU over 2 frames, (c) sparse at threshold 0.05 on xla (JAX's eval
     backend), (d) bf16 dense: one {"phase": "nyu_eval"} line each (the
     eight-metric row, frames/s, the predict and host-edge shares, the
     B=8 forward alone, density and GFLOPs when sparse). Checks: card vs
     CPU depths and six-metric row within 1e-4 (the edge metrics within
     1e-3 px), bf16 finite with a mean gap under 1% of the mean f32
     depth, thresh -1 sparse == dense bitwise; one B=8 and one B=1 sparse
     request on pallas, pallas2d and capacity (capacity_ratio 1.0) equal
     to xla within 1e-4 of each tensor's scale, with xla's masks and op
     counts and JAX's launches per forward (pallas: K1 x4; pallas2d: K4
     x2 + K1 x2; capacity: K1 x2), counted from 0 around each request;
     K1/K4 vs plain at the four NYU conv shapes (up2.convA 744->276 and
     up3.convA 372->138, reflect + LeakyReLU 0.2; the wave heads
     276->3 and 138->3, zero pad) on the requests' masks and on 5%
     maskgen base masks, B=8 and B=1, <= 1e-4. Times: those convs per
     kernel vs plain vs cuDNN with their bounds, the B=8 and B=1 forward
     dense and sparse on every backend at the 5% masks, MobileNetV2 +
     NyuDecoderWave at B=8, profiles of the B=8 and B=1 dense and the B=8
     pallas2d forwards (costliest kernels, ATen ops and convs), and the
     B=8 dense forward under cudnn.benchmark for comparison.

stdout: one JSON object per line (the card's nvidia-smi line and the
CLIs' progress lines aside); the line before the last is the kernels
summary (K1/K4 with the NYU path's `launches_nyu` and `*_nyu` B=8 sums)
and the last is {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 192, 640
TOL = 1e-4
# (H, W, Cin, Cout, epilogue, mask key, conv) of the 12 kernel launches
# of one sparse forward at 640x192: per scale upconv_i_0, upconv_i_1 and
# the pos and neg heads' 3x3 (same shape)
PATH_CONVS = [
    (12, 40, 256, 128, "elu", (3, "upconv0"), "upconv_3_0"),
    (24, 80, 256, 128, "elu", (3, "upconv1"), "upconv_3_1"),
    (24, 80, 128, 3, "sigmoid", (3, "wavelet"), "waveconv_3_pos/neg"),
    (24, 80, 128, 64, "elu", (2, "upconv0"), "upconv_2_0"),
    (48, 160, 128, 64, "elu", (2, "upconv1"), "upconv_2_1"),
    (48, 160, 64, 3, "sigmoid", (2, "wavelet"), "waveconv_2_pos/neg"),
    (48, 160, 64, 32, "elu", (1, "upconv0"), "upconv_1_0"),
    (96, 320, 96, 32, "elu", (1, "upconv1"), "upconv_1_1"),
    (96, 320, 32, 3, "sigmoid", (1, "wavelet"), "waveconv_1_pos/neg"),
]
# the same 12 launches for KITTI ResNet50 at 1024x320, the largest
# published row: upconv_3_1 and upconv_2_1 take ResNet50's wider skips
# (512 and 256 channels: Cin 128 + 512, 64 + 256)
R50_H, R50_W = 320, 1024
PATH_CONVS_R50 = [
    (20, 64, 256, 128, "elu", (3, "upconv0"), "upconv_3_0"),
    (40, 128, 640, 128, "elu", (3, "upconv1"), "upconv_3_1"),
    (40, 128, 128, 3, "sigmoid", (3, "wavelet"), "waveconv_3_pos/neg"),
    (40, 128, 128, 64, "elu", (2, "upconv0"), "upconv_2_0"),
    (80, 256, 320, 64, "elu", (2, "upconv1"), "upconv_2_1"),
    (80, 256, 64, 3, "sigmoid", (2, "wavelet"), "waveconv_2_pos/neg"),
    (80, 256, 64, 32, "elu", (1, "upconv0"), "upconv_1_0"),
    (160, 512, 96, 32, "elu", (1, "upconv1"), "upconv_1_1"),
    (160, 512, 32, 3, "sigmoid", (1, "wavelet"), "waveconv_1_pos/neg"),
]
KERNELS = {
    "conv3x3_tile_sparse": "wavelet_monodepth_tpu/ops/pallas_conv.py:124",
    "conv3x3_tile_sparse_2d": "wavelet_monodepth_tpu/ops/pallas_conv.py:274",
}
SOURCES = {name: f"wavelet_monodepth_tpu_torch/csrc/{name}.cu"
           for name in ("tile_sparse_conv", "banded_warp", "blockio",
                        "fused_wave_stage")}
WARP_REPLACES = "wavelet_monodepth_tpu/ops/warp.py:205"
BLOCKIO_REPLACES = {"band_gather": "wavelet_monodepth_tpu/ops/blockio.py:82",
                    "block_scatter":
                        "wavelet_monodepth_tpu/ops/blockio.py:129"}
FUSED_REPLACES = "wavelet_monodepth_tpu/ops/pallas_fused.py:182"
COMPACTED = ("compact", "sites", "capacity")
# high-res px at the image border, per disp scale, where "compact" may
# differ from xla: each compacted stage's <= 2 px ring (tiles pad their
# inputs, xla its features), widened by the next stages' convs and
# upsampling and doubled by each IDWT; scale 3 comes from the dense stage
COMPACT_RING = {3: 0, 2: 4, 1: 16, 0: 36}
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, and the dense TF32 tensor rate
# over 3: float32 accuracy on the tensor cores in 3xTF32 (three products
# per multiply-add), the tile conv's route
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3

_card = {}


def require(ok, what) -> None:
    """A check that holds under `python -O` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()


# --- phase 1: device -------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = card_line()
    print(line, flush=True)
    name, limit = [s.strip() for s in line.split(",")]
    _card.update(card=name, power_limit=limit)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, **_card})
    return torch.device("cuda", 0)


# --- phase 2: build --------------------------------------------------------

def phase_build():
    """Every source, one nvcc each, started together."""
    from wavelet_monodepth_tpu_torch.kernels import build
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.ops import warp
    t0 = time.perf_counter()
    build.load_all(list(SOURCES))
    for module in (tsc, warp, bio, fs):
        module._kernel_lib()
    for name in SOURCES:
        info = build.build_info[name]
        usage = [ln.split("info    :")[-1].strip()
                 for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "source": SOURCES[name],
              "nvcc_seconds": info["seconds"], "ptxas": usage})
    emit({"phase": "build", "seconds": time.perf_counter() - t0})


# --- phase 3: kernel vs plain ----------------------------------------------

def edge_stage_masks(batch, seed=0, h=H, w=W):
    """{scale i: stage_masks(...)} of the 10% maskgen operating point, and
    the raw masks, on the CPU."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import sparse as sp
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp = mg.synthetic_depth_scene(batch, h, w, seed=seed)
    raw, ratio, dens = mg.masks_at_density(disp, 0.10)
    raw = {i: torch.from_numpy(m) for i, m in raw.items()}
    return disp, raw, ratio, dens, {i: sp.stage_masks(m)
                                    for i, m in raw.items()}


def phase_kernel_vs_plain(dev, errs):
    import torch
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    nl = {"none": None, "elu": tsc.elu, "sigmoid": tsc.sigmoid,
          "leaky01": tsc.leaky_relu_01, "leaky02": tsc.leaky_relu_02}
    g = torch.Generator().manual_seed(1)

    def check(case, x, w, b, m, pad, epi):
        ref = tsc.conv3x3_masked_plain(x, w, b, m, pad, nl[epi])
        for key in KERNELS:
            out = getattr(tsc, key)(x, w, b, m, pad, nl[epi])
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            errs[key] = max(errs[key], err)
            emit({"phase": "kernel_vs_plain", "kernel": key, **case,
                  "pad": pad, "nonlin": epi, "max_abs_err": err})
            require(out.dtype == torch.float32 and out.shape == ref.shape,
                    (key, case, out.dtype, tuple(out.shape)))
            require(err <= TOL, (key, case, err))

    def data(n, h, w, cin, cout):
        x = torch.randn(n, h, w, cin, generator=g).to(dev)
        wt = (torch.randn(3, 3, cin, cout, generator=g)
              * (2.0 / (9 * cin)) ** 0.5).to(dev)
        b = (torch.randn(cout, generator=g) * 0.1).to(dev)
        return x, wt, b

    for model, size, convs in (("resnet18", (H, W), PATH_CONVS),
                               ("resnet50", (R50_H, R50_W), PATH_CONVS_R50)):
        for batch in (1, 16):
            _, _, _, _, stage = edge_stage_masks(batch, 0, *size)
            for h, w, cin, cout, epi, (i, mk), conv in convs:
                m = stage[i][mk].to(dev)
                require(m.shape == (batch, h, w, 1), (conv, m.shape))
                check({"model": model, "conv": conv,
                       "shape": [batch, h, w, cin, cout],
                       "mask_density": float(m.mean())},
                      *data(batch, h, w, cin, cout), m, "reflect", epi)
    for cin, cout in ((6, 5), (40, 24)):
        x, w, b = data(2, 20, 72, cin, cout)
        m = (torch.rand(2, 20, 72, 1, generator=g) > 0.9).float().to(dev)
        for pad in ("reflect", "zero", "replicate"):
            for epi in nl:
                check({"case": "modes", "shape": [2, 20, 72, cin, cout]},
                      x, w, b, m, pad, epi)
    for name, h, w in (("all_zero", 16, 128), ("all_one", 16, 128),
                       ("ragged", 13, 70), ("ragged_small", 3, 5)):
        x, wt, b = data(2, h, w, 33, 17)
        if name == "all_zero":
            m = torch.zeros(2, h, w, 1, device=dev)
        elif name == "all_one":
            m = torch.ones(2, h, w, 1, device=dev)
        else:
            m = (torch.rand(2, h, w, 1, generator=g) > 0.5).float().to(dev)
        check({"case": name, "shape": [2, h, w, 33, 17]}, x, wt, b, m,
              "reflect", "elu")
        if name == "all_zero":
            out = tsc.conv3x3_tile_sparse(x, wt, b, m, "reflect", tsc.elu)
            require(not out.any(), "skipped granules must be zero")


# --- phase 4: the serving slice --------------------------------------------

def build_models(dev, seed=0, depth=18):
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
        KittiWaveletDecoder
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
    gen = torch.Generator().manual_seed(seed)
    enc = init_params(ResnetEncoder(depth), gen)
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), gen)
    return enc.to(dev).eval(), dec.to(dev).eval()


def raw_masks_of(out):
    """{scale i: raw (N, h, w, 1) mask} recovered from a sparse output."""
    return {s + 1: out[("wavelet_mask", s)][:, ::2, ::2].contiguous()
            for s in (0, 1, 2)}


def same_answer(ours, ref, thresh, rerun):
    """disp within TOL of the xla answer. Where a threshold mask differs,
    xla reruns under the kernel run's masks (`rerun(masks)`), so every
    scale sees the same history, and each kernel-run mask pixel must equal
    that rerun's own threshold decision or lie where max |yh| is within
    1e-5 of the threshold."""
    import torch
    flips = {s: int((ours[("wavelet_mask", s)]
                     != ref[("wavelet_mask", s)]).sum()) for s in range(3)}
    if any(flips.values()):
        raw = raw_masks_of(ours)
        ref = rerun(raw)
        for i in (1, 2, 3):     # scale i thresholds scale i+1's yh
            yl = ref[("wavelets", i - 1, "LL")]
            yh = torch.cat([ref[("wavelets", i, b)]
                            for b in ("LH", "HL", "HH")], -1)
            t = (yl.amax(dim=(1, 2, 3)) - yl.amin(dim=(1, 2, 3))) * thresh
            peak = yh.abs().amax(-1)
            decided = (peak > t[:, None, None]).float()
            margin = (peak - t[:, None, None]).abs()
            require(bool(((raw[i][..., 0] == decided) | (margin < 1e-5))
                         .all()),
                    f"mask differs away from the threshold at scale {i}")
    err = max(float((ours[("disp", s)] - ref[("disp", s)]).abs().max())
              for s in range(4))
    require(all(bool(torch.isfinite(ours[("disp", s)]).all())
                for s in range(4)), "finite disparity")
    require(err <= TOL, ("disp vs xla", err))
    return err, flips


def phase_slice(dev):
    enc, dec = build_models(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = serve(dev, enc, dec, tmp)
    return launches, enc, dec


def serve(dev, enc, dec, tmp):
    """The server, its requests and the CLI run, with files under tmp."""
    import numpy as np
    import torch
    from PIL import Image
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.tools import infer
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg

    ckpt = os.path.join(tmp, "weights")
    ti.save_reference_checkpoint(ckpt, enc, dec, H, W)
    imgdir = os.path.join(tmp, "images")
    os.makedirs(imgdir)
    disp = mg.synthetic_depth_scene(4, 375, 1242, seed=7)   # KITTI size
    imgs = (mg.scene_image(disp, seed=7) * 255).astype(np.uint8)
    paths = []
    for k in range(4):
        paths.append(os.path.join(imgdir, f"scene_{k}.png"))
        Image.fromarray(imgs[k]).save(paths[-1])

    argv = ["--image_path", imgdir, "--torch_model_path", ckpt,
            "--use_sparse", "--threshold", "0.1"]
    args = infer.parse_args(argv)
    servers = {}
    for backend in ("pallas", "pallas2d", "xla") + COMPACTED:
        servers[backend], feed = infer.load_model(args, dev, backend)
        require(feed == (H, W), feed)
    # each backend's kernel launches per request
    per_request = {"pallas": {"conv3x3_tile_sparse": 12},
                   "pallas2d": {"conv3x3_tile_sparse_2d": 12},
                   "compact": {"band_gather": 18, "block_scatter": 6},
                   "sites": {}, "capacity": {}}

    def counts():
        return {**tsc.launches, **bio.launches}

    def rerun(x):
        def f(masks):
            with torch.inference_mode():
                return dec(enc(x), thresh_ratio=args.threshold,
                           mask_override=masks)
        return f

    # the main path: every count starts at 0 here and is read right after
    requests = [torch.from_numpy(infer.preprocess_image(p, W, H)[0]).to(dev)
                for p in paths]
    torch.cuda.synchronize()
    tsc.reset_launches()
    bio.reset_launches()
    answers = []
    for x in requests:
        per = {}
        for backend in per_request:
            before = counts()
            per[backend] = servers[backend](x, args.threshold)
            per[backend + "_launches"] = {
                k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        answers.append(per)
    torch.cuda.synchronize()
    launches = counts()

    for k, (x, per) in enumerate(zip(requests, answers)):
        ref = servers["xla"](x, args.threshold)
        for backend, want in per_request.items():
            out = per[backend]
            require(per[backend + "_launches"] == want,
                    ("launches per request", backend,
                     per[backend + "_launches"]))
            require(all(bool(torch.isfinite(out[("disp", s)]).all())
                        for s in range(4)), (backend, "finite disparity"))
            row = {"phase": "slice", "request": k, "backend": backend,
                   "launches": per[backend + "_launches"],
                   "density": float(compute_density(out))}
            overflow = {s: int(out[("overflow", s)]) for s in range(3)
                        if ("overflow", s) in out}
            # an exact backend that dropped nothing must give xla's answer
            if backend != "compact" and not any(overflow.values()):
                err, flips = same_answer(out, ref, args.threshold,
                                         rerun(x))
                row.update(disp_max_abs_err_vs_xla=err, mask_flips=flips)
            emit({**row, "overflow_at_cap_0.5": overflow})
    require(launches == {"conv3x3_tile_sparse": 48,
                         "conv3x3_tile_sparse_2d": 48,
                         "band_gather": 72, "block_scatter": 24}, launches)

    infer.main(argv, device=dev)
    for p in paths:
        stem = os.path.splitext(p)[0]
        need = [stem + "_disp.npy", stem + "_disp.jpeg"] + [
            f"{stem}_scale_{s}_wavelets.npy" for s in range(4)]
        require(all(os.path.isfile(f) for f in need), need)
        d = np.load(stem + "_disp.npy")
        require(d.shape == (1, 1, H, W) and np.isfinite(d).all(),
                ("disp.npy", d.shape))
    emit({"phase": "infer_main", "images": len(paths), "files": "ok"})
    return launches


# --- phase 5: contracts ----------------------------------------------------

def phase_contracts(dev, enc, dec):
    import torch
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, H, W, 3, generator=g).to(dev)
    with torch.inference_mode():
        feats = enc(x)
        dense = dec(feats)
        for backend in (False, "pallas", "pallas2d"):
            sp = dec(feats, thresh_ratio=-1.0, use_pallas=backend)
            err = max(float((sp[("disp", s)] - dense[("disp", s)]).abs()
                            .max()) for s in range(4))
            if backend is False:
                require(all(torch.equal(sp[("disp", s)], dense[("disp", s)])
                            for s in range(4)), "thresh=-1 not bitwise dense")
            require(err <= TOL, (backend, err))
            emit({"phase": "contract_thresh_minus1",
                  "backend": backend or "xla", "max_abs_err": err})
    torch.backends.cudnn.deterministic = False

    disp, raw, ratio, dens, _ = edge_stage_masks(16, seed=0)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    mo = {i: m.to(dev) for i, m in raw.items()}
    with torch.inference_mode():
        feats = enc(img)
        ref = dec(feats, thresh_ratio=ratio, mask_override=mo)
        for backend in ("pallas", "pallas2d"):
            out = dec(feats, thresh_ratio=ratio, mask_override=mo,
                      use_pallas=backend)
            err = max(float((out[("disp", s)] - ref[("disp", s)]).abs()
                            .max()) for s in range(4))
            ops_equal = all(torch.equal(out[k], ref[k]) for k in ref
                            if k[0] == "total_ops")
            require(err <= TOL and ops_equal, (backend, err, ops_equal))
            emit({"phase": "contract_operating_point", "batch": 16,
                  "backend": backend, "disp_max_abs_err_vs_xla": err,
                  "total_ops_equal": ops_equal,
                  "density": float(compute_density(out)),
                  "maskgen_density": dens,
                  "mean_total_ops": float(out[("total_ops", -1)].mean())})
        # the compacted backends: exact at compact_cap 1.0 (compact away
        # from its border ring), and what 0.5 drops
        for backend in COMPACTED:
            ring = COMPACT_RING if backend == "compact" else dict.fromkeys(
                range(4), 0)
            row = {"phase": "contract_operating_point", "batch": 16,
                   "backend": backend, "maskgen_density": dens}
            for cap in (1.0, 0.5):
                out = dec(feats, thresh_ratio=ratio, mask_override=mo,
                          use_pallas=backend, compact_cap=cap)
                err = max(float(interior(out[("disp", s)]
                                         - ref[("disp", s)], ring[s])
                                .abs().max()) for s in range(4))
                overflow = {s: int(out[("overflow", s)]) for s in range(3)}
                ops_equal = all(torch.equal(out[k], ref[k]) for k in ref
                                if k[0] == "total_ops")
                row[f"cap_{cap}"] = {"disp_max_abs_err_vs_xla": err,
                                     "overflow": overflow,
                                     "total_ops_equal": ops_equal}
                if cap == 1.0:
                    require(err <= TOL and ops_equal
                            and not any(overflow.values()),
                            (backend, row))
            emit({**row, "border_ring_px": ring})


def phase_contracts_r50(dev):
    """One KITTI ResNet50 1024x320 B=1 request (seeded weights, the 10%
    maskgen masks) on pallas, pallas2d and compact (compact_cap 1.0),
    each held to xla under phase 5's contracts: within TOL (compact away
    from its ring), xla's op counts, no overflow; the conv kernels at
    ResNet50's skip widths, 12 launches each."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg

    enc, dec = build_models(dev, seed=5, depth=50)
    disp, raw, ratio, dens, _ = edge_stage_masks(1, 0, R50_H, R50_W)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    mo = {i: m.to(dev) for i, m in raw.items()}
    want = {"pallas": {"conv3x3_tile_sparse": 12},
            "pallas2d": {"conv3x3_tile_sparse_2d": 12},
            "compact": {"band_gather": 18, "block_scatter": 6}}
    with torch.inference_mode():
        feats = enc(img)
        require([f.shape[-1] for f in feats] == [64, 256, 512, 1024, 2048],
                [tuple(f.shape) for f in feats])
        ref = dec(feats, thresh_ratio=ratio, mask_override=mo)
        for backend, launches in want.items():
            ring = COMPACT_RING if backend == "compact" else dict.fromkeys(
                range(4), 0)
            before = {**tsc.launches, **bio.launches}
            out = dec(feats, thresh_ratio=ratio, mask_override=mo,
                      use_pallas=backend, compact_cap=1.0)
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in {**tsc.launches,
                                                 **bio.launches}.items()
                   if v != before[k]}
            err = max(float(interior(out[("disp", s)] - ref[("disp", s)],
                                     ring[s]).abs().max()) for s in range(4))
            overflow = {s: int(out[("overflow", s)]) for s in range(3)
                        if ("overflow", s) in out}
            ops_equal = all(torch.equal(out[k], ref[k]) for k in ref
                            if k[0] == "total_ops")
            row = {"phase": "contract_resnet50", "res": [R50_H, R50_W],
                   "batch": 1, "backend": backend, "compact_cap": 1.0,
                   "disp_max_abs_err_vs_xla": err, "border_ring_px": ring,
                   "total_ops_equal": ops_equal, "overflow": overflow,
                   "launches": got, "maskgen_density": dens,
                   "density": float(compute_density(out))}
            require(err <= TOL and ops_equal and not any(overflow.values())
                    and got == launches, row)
            emit(row)


def interior(t, r: int):
    """t (N, H, W, C) without an r-pixel border."""
    return t[:, r:t.shape[1] - r, r:t.shape[2] - r]


# --- phase 5a: bf16 serving --------------------------------------------------

# tests/test_bf16.py's bounds for bf16 disparity against float32
BF16_DISP_MAX, BF16_DISP_MEAN = 0.05, 0.01
BF16_SERVED = ("xla",) + COMPACTED


def bf16_copies(enc, dec):
    """The full bf16 cast of tools/infer.py --bfloat16, on copies."""
    import copy
    import torch
    from wavelet_monodepth_tpu_torch.utils.precision import cast_floats
    return (cast_floats(copy.deepcopy(enc), torch.bfloat16),
            cast_floats(copy.deepcopy(dec), torch.bfloat16))


def disp_gap(ours, ref, ring=None) -> dict:
    """max and mean |disp| difference per scale (away from ring[s] px)."""
    out = {}
    for s in range(4):
        d = (ours[("disp", s)].float() - ref[("disp", s)].float()).abs()
        d = interior(d, ring[s]) if ring else d
        out[s] = {"max": float(d.max()), "mean": float(d.mean())}
    return out


def phase_bf16_serving(dev, enc, dec):
    """bf16 servers from tools/infer.load_model(--bfloat16) on xla and the
    compacted backends (compact_cap 1.0) answer B=16 and B=1 requests at
    the 10% maskgen operating point: every count starts at 0 just before
    and is read just after. Disparity within BF16_DISP_MAX / _MEAN of the
    float32 server of the same backend on the same weights; op counts
    equal to xla bf16's and no overflow; each compacted backend within
    the same bounds of xla bf16 (compact away from its ring); the
    tile-conv backends raise in bf16, as JAX cannot lower them. Returns
    the bf16 launches."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.tools import infer
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        ckpt = os.path.join(tmp, "weights")
        ti.save_reference_checkpoint(ckpt, enc, dec, H, W)
        base = ["--image_path", tmp, "--torch_model_path", ckpt]
        args32 = infer.parse_args(base)
        args16 = infer.parse_args(base + ["--bfloat16"])
        f32 = {b: infer.load_model(args32, dev, b, compact_cap=1.0)[0]
               for b in BF16_SERVED}
        servers = {b: infer.load_model(args16, dev, b, compact_cap=1.0)[0]
                   for b in BF16_SERVED}
        for b in ("pallas", "pallas2d"):
            try:
                infer.load_model(args16, dev, b)
            except NotImplementedError as e:
                emit({"phase": "bf16_serving", "backend": b,
                      "raises": str(e)})
            else:
                require(False, (b, "served bf16"))

    requests = []
    for batch in (16, 1):
        disp, raw, ratio, dens, _ = edge_stage_masks(batch)
        img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
        requests.append((batch, img, {i: m.to(dev) for i, m in raw.items()},
                         ratio, dens))
    # the bf16 serving path: counts from 0, read right after
    torch.cuda.synchronize()
    tsc.reset_launches()
    bio.reset_launches()
    answers = [{b: servers[b](img, ratio, mask_override=mo)
                for b in BF16_SERVED} for _, img, mo, ratio, _ in requests]
    torch.cuda.synchronize()
    launches = {k + "_bf16": v for k, v in bio.launches_bf16.items()}
    require(launches == {"band_gather_bf16": 18 * len(requests),
                         "block_scatter_bf16": 6 * len(requests)}, launches)
    require(bio.launches == {"band_gather": 18 * len(requests),
                             "block_scatter": 6 * len(requests)}
            and not any(tsc.launches.values()),
            ("other launches in bf16", bio.launches, tsc.launches))

    for (batch, img, mo, ratio, dens), per in zip(requests, answers):
        for b, out in per.items():
            ref32 = f32[b](img, ratio, mask_override=mo)
            require(all(v.dtype != torch.bfloat16 for v in out.values()),
                    (b, "outputs come back float32"))
            require(all(bool(torch.isfinite(out[("disp", s)]).all())
                        for s in range(4)), (b, "finite disparity"))
            vs32 = disp_gap(out, ref32)
            overflow = {s: int(out[("overflow", s)]) for s in range(3)
                        if ("overflow", s) in out}
            ops_equal = all(torch.equal(out[k], per["xla"][k])
                            for k in per["xla"] if k[0] == "total_ops")
            row = {"phase": "bf16_serving", "backend": b, "batch": batch,
                   "compact_cap": 1.0, "maskgen_density": dens,
                   "disp_vs_f32": vs32, "total_ops_equal_xla_bf16":
                   ops_equal, "overflow": overflow}
            require(ops_equal and not any(overflow.values()), row)
            require(all(v["max"] <= BF16_DISP_MAX
                        and v["mean"] <= BF16_DISP_MEAN
                        for v in vs32.values()), row)
            if b != "xla":
                ring = COMPACT_RING if b == "compact" else None
                row["disp_vs_xla_bf16"] = gap = disp_gap(out, per["xla"],
                                                         ring)
                row["border_ring_px"] = ring
                require(all(v["max"] <= BF16_DISP_MAX
                            and v["mean"] <= BF16_DISP_MEAN
                            for v in gap.values()), row)
            emit(row)
    return launches


# --- phase 5b: the block IO kernels (K5, K6) vs plain -----------------------

def record_block_io(run):
    """run() with band_gather / block_scatter recorded: [(name, args,
    out)] in call order, args as the wrapper got them."""
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    calls = []
    orig = {"band_gather": bio.band_gather,
            "block_scatter": bio.block_scatter}

    def recorder(name):
        def f(*args):
            out = orig[name](*args)
            calls.append((name, args, out))
            return out
        return f

    bio.band_gather = recorder("band_gather")
    bio.block_scatter = recorder("block_scatter")
    try:
        run()
    finally:
        bio.band_gather = orig["band_gather"]
        bio.block_scatter = orig["block_scatter"]
    return calls


def compact_forward(enc, dec, img, raw, ratio, cap=0.5):
    def run():
        import torch
        with torch.inference_mode():
            dec(enc(img), thresh_ratio=ratio, mask_override=raw,
                use_pallas="compact", compact_cap=cap)
    return run


def phase_block_io_vs_plain(dev, enc, dec, errs, dtype):
    """Every gather and scatter of a compact forward at B=16 and B=1 (the
    kernel's own output, recorded on the path, against the plain version
    on the same inputs), then every tile of stacks with odd row widths;
    in `dtype` (enc and dec cast to it), whose errors go to errs[name] for
    float32 and errs[name + "_bf16"] for bfloat16."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    plain = {"band_gather": bio.band_gather_plain,
             "block_scatter": bio.block_scatter_plain}
    suffix = "_bf16" if dtype == torch.bfloat16 else ""

    def check(case, name, args, out):
        ref = plain[name](*args)
        torch.cuda.synchronize()
        same = out.shape == ref.shape and torch.equal(out, ref)
        err = float((out - ref).abs().max()) if out.shape == ref.shape \
            else float("inf")
        errs[name + suffix] = max(errs[name + suffix], err)
        require(same and out.dtype == dtype, (name, case, str(dtype), err))
        return err

    for batch in (16, 1):
        disp, raw, ratio, _, _ = edge_stage_masks(batch)
        img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev, dtype)
        raw = {i: m.to(dev) for i, m in raw.items()}
        calls = record_block_io(compact_forward(enc, dec, img, raw, ratio))
        names = [c[0] for c in calls]
        require(names.count("band_gather") == 18
                and names.count("block_scatter") == 6, names)
        for k, (name, args, out) in enumerate(calls):
            err = check({"batch": batch, "call": k}, name, args, out)
            emit({"phase": "block_io_vs_plain", "kernel": name,
                  "dtype": str(dtype), "batch": batch, "call": k,
                  "in": list(args[0].shape), "out": list(out.shape),
                  "equal": True, "max_abs_err": err})
        del calls

    # every tile, the last row block included, at windows th, th + 2*halo
    # and 2*th; C = 1 / 3 rows of odd widths take the scalar copies
    g = torch.Generator().manual_seed(5)
    for c, tw, halo in ((64, 16, 2), (1, 16, 1), (1, 17, 1), (3, 7, 0),
                        (1, 9, 2)):
        n, h, w, th = 2, 21, 70, 8
        x = torch.randn(n, h, w, c, generator=g).to(dev, dtype)
        stack = bio.wtile_stack(x, th, tw, halo)
        nh, nw = -(-h // th), -(-w // tw)
        idx = torch.stack(torch.meshgrid(
            torch.arange(n), torch.arange(nh), torch.arange(nw),
            indexing="ij"), -1).reshape(-1, 3)
        idx = idx[torch.randperm(len(idx), generator=g)].to(torch.int32)
        idx = idx.to(dev)
        for window_h in sorted({th, th + 2 * halo, 2 * th}):
            out = bio.band_gather(stack, idx, th, window_h)
            check({"c": c, "tw": tw, "window_h": window_h}, "band_gather",
                  (stack, idx, th, window_h), out)
        vals = torch.randn(len(idx) - 1, th, tw, c, generator=g).to(
            dev, dtype)
        out = bio.block_scatter(vals, idx[1:], n, nh, nw)
        check({"c": c, "tw": tw}, "block_scatter", (vals, idx[1:], n, nh, nw),
              out)
        emit({"phase": "block_io_vs_plain", "case": "every tile",
              "dtype": str(dtype), "c": c, "tw": tw, "halo": halo,
              "equal": True})


def no_scatter_faults(dev, after: str) -> None:
    """The scatter kernel counts idx rows outside the grid or naming a tile
    twice on the card; none may have come since the run began."""
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    faults = bio.scatter_faults(dev)
    emit({"phase": "scatter_faults", "after": after, "faults": faults})
    require(faults == 0, ("block_scatter faults", after, faults))


def count_syncs(run) -> dict:
    """run() under torch.cuda.set_sync_debug_mode("warn"): its
    synchronising calls, each at the innermost line of this repo on the
    stack, and how many of them came from inside block IO's
    block_scatter."""
    import collections
    import traceback
    import warnings
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    orig, found, in_scatter = bio.block_scatter, [], []

    def on_warning(message, *rest):
        if "synchroniz" in str(message):
            where = [f for f in traceback.extract_stack()[:-1]
                     if f.filename.startswith(REPO + os.sep)][-1]
            found.append(f"{os.path.relpath(where.filename, REPO)}:"
                         f"{where.lineno}")

    def counted(*args):
        before = len(found)
        out = orig(*args)
        in_scatter.append(len(found) - before)
        return out

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        bio.block_scatter = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            bio.block_scatter = orig
    return {"syncs": len(found), "block_scatter_calls": len(in_scatter),
            "syncs_in_block_scatter": sum(in_scatter),
            "where": collections.Counter(found)}


def phase_sync_count(dev, enc, dec) -> None:
    """The synchronising calls of one B=16 compact forward (float32, 10%
    maskgen masks, compact_cap 1.0), after one warm-up forward;
    block_scatter's calls may make none."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = edge_stage_masks(16)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    raw = {i: m.to(dev) for i, m in raw.items()}
    run = compact_forward(enc, dec, img, raw, ratio, cap=1.0)
    run()
    torch.cuda.synchronize()
    # the debug mode's own first use, with no forward inside
    idle = count_syncs(lambda: None)
    counts = count_syncs(run)
    emit({"phase": "sync_count", "forward": "compact, B=16, float32, "
          "compact_cap 1.0", **counts, "syncs_with_no_forward": idle})
    require(counts["block_scatter_calls"] == 6
            and counts["syncs_in_block_scatter"] == 0, counts)


# --- phase 5c: the fused wave stage (K2) vs plain and the oracle ------------

FUSED_SCALES = (3, 2, 1)


def stage_inputs(enc, dec, img, raw, ratio):
    """{scale i: (x, skip, yl, mask)} entering scales 3, 2 and 1 of the
    masked-dense (xla) sparse forward under the raw masks: the decoder's
    own stage inputs."""
    import torch
    seen = {}
    hooks = [dec.blocks[f"upconv_{i}_0"].register_forward_pre_hook(
        lambda mod, args, i=i: seen.__setitem__(i, args[0]))
        for i in FUSED_SCALES]
    try:
        with torch.inference_mode():
            feats = enc(img)
            out = dec(feats, thresh_ratio=ratio, mask_override=raw)
    finally:
        for hook in hooks:
            hook.remove()
    return {i: (seen[i], feats[i - 1], out[("wavelets", i - 1, "LL")],
                raw[i]) for i in FUSED_SCALES}


def oracle_stage(dec, i, x, skip, yl, mask):
    """Scale i by masked dense cuDNN convs (ops/sparse.py), as
    tests/test_pallas_fused.py's oracle: (yh, yl_new, x1)."""
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import sparse as sp
    from wavelet_monodepth_tpu_torch.ops.wavelets import haar_idwt
    m = sp.stage_masks(mask)
    c0 = dec.blocks[f"upconv_{i}_0"].conv.conv
    c1 = dec.blocks[f"upconv_{i}_1"].conv.conv
    x0 = sp.masked_conv3x3(x, c0.weight, c0.bias, m["lowres"], m["upconv0"],
                           "reflect", F.elu)
    u = sp.masked_upsample_concat(x0, skip, m["upsample"])
    x1 = sp.masked_conv3x3(u, c1.weight, c1.bias, None, m["upconv1"],
                           "reflect", F.elu)
    heads = []
    for head in ("pos", "neg"):
        wv = dec.blocks[f"waveconv_{i}_{head}"]
        heads.append(sp.masked_waveconv(
            x1, wv[0].conv.weight, wv[0].conv.bias, wv[2].conv.weight,
            wv[2].conv.bias, m["upconv1"], m["wavelet"]))
    yh = (2.0 ** (i - 1)) * (heads[0] - heads[1])
    return yh, haar_idwt(yl, yh[..., 0:1], yh[..., 1:2], yh[..., 2:3]), x1


def fused_plain(x, skip, yl, mask, params, i, ht=8, tw=64):
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    inp = fs._stage_inputs(x, skip, yl, mask, ht, tw)
    return fs.assemble(*fs.fused_wave_stage_plain(inp, params, i, ht, tw),
                       2 * x.shape[1], 2 * x.shape[2])


def fused_inputs(enc, dec, dev, batch):
    """stage_inputs of `batch` maskgen scenes under their 10% masks."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = edge_stage_masks(batch)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    raw = {i: m.to(dev) for i, m in raw.items()}
    return stage_inputs(enc, dec, img, raw, ratio)


def phase_fused_stage(dev, enc, dec, errs):
    """K2 driven on the decoder's stage inputs at scales 3, 2, 1, B=16 and
    B=1 (the 10% maskgen masks; counted), then checked against its plain
    version and the oracle's interior, also under all-zero and all-one
    masks (not counted). Returns the counted launches and the stage
    inputs {batch: {scale: (x, skip, yl, mask)}}."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    ring = {"yh": 2, "yl_new": 4, "x1": 2}
    inputs = {batch: fused_inputs(enc, dec, dev, batch) for batch in (16, 1)}
    runs = []
    torch.cuda.synchronize()
    fs.reset_launches()
    with torch.inference_mode():
        for batch in (16, 1):
            for i, (x, skip, yl, mask) in inputs[batch].items():
                runs.append((batch, i, "maskgen", mask, fs.fused_wave_stage(
                    x, skip, yl, mask, *dec.stage_params(i), i_scale=i)))
    torch.cuda.synchronize()
    launches = fs.launches["fused_wave_stage"]
    require(launches == 2 * len(FUSED_SCALES), launches)
    with torch.inference_mode():
        for batch in (16, 1):
            for i, (x, skip, yl, mask) in inputs[batch].items():
                for kind, m in (("zeros", torch.zeros_like(mask)),
                                ("ones", torch.ones_like(mask))):
                    runs.append((batch, i, kind, m, fs.fused_wave_stage(
                        x, skip, yl, m, *dec.stage_params(i), i_scale=i)))
        for batch, i, kind, mask, ours in runs:
            x, skip, yl, _ = inputs[batch][i]
            params = dec.stage_params(i)
            plain = fused_plain(x, skip, yl, mask, params, i)
            oracle = oracle_stage(dec, i, x, skip, yl, mask)
            row = {"phase": "fused_vs_plain", "batch": batch, "scale": i,
                   "mask": kind, "mask_density": float(mask.mean())}
            for name, o, p, r in zip(ring, ours, plain, oracle):
                require(o.shape == p.shape == r.shape
                        and bool(torch.isfinite(o).all()), (row, name))
                err = float((o - p).abs().max())
                err_oracle = float(interior(o - r, ring[name]).abs().max())
                errs["fused_wave_stage"] = max(errs["fused_wave_stage"], err)
                row[name] = {"max_abs_err": err,
                             "oracle_interior_max_abs_err": err_oracle}
                require(err <= TOL and err_oracle <= TOL, (row, name))
            if kind == "zeros":
                require(not ours[0].any() and not ours[2].any(), row)
            emit(row)
    return launches, inputs


# --- phase 6: times ----------------------------------------------------------

def time_variants(variants: dict, iters: int, windows: int = 3,
                  queue_ahead: bool = False) -> dict:
    """ms per call of each variant: warm-up, then `windows` windows of
    `iters` calls timed with CUDA events, interleaved (a, b, b, a, ...).
    queue_ahead: each window starts behind a ~10 ms device-side sleep, so
    the host queues all its calls before the card reaches them and the
    events time the device, not the launch overhead (for kernels of tens
    of microseconds)."""
    import torch
    for fn in variants.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    ms = {k: [] for k in variants}
    order = list(variants)
    for wi in range(windows):
        for k in (order if wi % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queue_ahead:
                torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(iters):
                variants[k]()
            end.record()
            end.synchronize()
            ms[k].append(start.elapsed_time(end) / iters)
    return {k: {"ms_median": statistics.median(v), "ms_min": min(v),
                "ms_max": max(v)} for k, v in ms.items()}


def conv_bound_ms(m, cin: int, cout: int):
    """(bound ms, bound by, the bound at the f32 CUDA-core rate) of one
    masked 3x3 conv: the least time at float32 accuracy, the FLOPs of its
    active outputs at the 3xTF32 tensor rate or the bytes it must move
    (the input pixels those outputs read, weights, mask, the whole
    output) at HBM rate, whichever takes longer; the third value puts the
    FLOPs at the CUDA cores' f32 peak instead (the bound PRs 1-3 used)."""
    import torch.nn.functional as F
    n, h, w, _ = m.shape
    active = float(m.sum())
    needed = float(F.max_pool2d(m.permute(0, 3, 1, 2), 3, 1, 1).sum())
    flops = 2.0 * 9 * cin * cout * active
    nbytes = 4.0 * (needed * cin + 9 * cin * cout + cout + n * h * w
                    + n * h * w * cout)
    t_ops, t_bytes = flops / TF32X3_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes
            else "bytes", max(flops / F32_FLOPS * 1e3, t_bytes))


def granule_work(m, cin: int, cout: int) -> dict:
    """Per flag mode (K1's 8-row stripes, K4's (8, 64) tiles): the share of
    granules with an active pixel, and the dense conv FLOPs over the
    pixels of those granules (what the kernel computes)."""
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    n, h, w, _ = m.shape
    hp, wp = -(-h // 8) * 8, -(-w // 64) * 64
    out = {}
    for key, flags, shape in (
            ("conv3x3_tile_sparse", tsc.stripe_flags(m, 8), (n, hp // 8, 1)),
            ("conv3x3_tile_sparse_2d", tsc.tile_flags_2d(m, 8, 64),
             (n, hp // 8, wp // 64))):
        f = flags.reshape(shape).float()
        px = f.repeat_interleave(8, 1)[:, :h]
        px = (px.repeat_interleave(64, 2)[:, :, :w] if shape[2] > 1
              else px.expand(n, h, w))
        out[key] = {"active_share": float(f.mean()),
                    "active_flops": 2.0 * 9 * cin * cout * float(px.sum())}
    return out


def phase_times(dev, enc, dec, kernel_ms):
    """Adds to kernel_ms the B=16 per-forward sums (12 launches): kernel,
    plain version, bound and cuDNN's dense F.conv2d at the same shape."""
    import torch
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    g = torch.Generator().manual_seed(2)
    nl = {"elu": tsc.elu, "sigmoid": tsc.sigmoid}
    bound_by = {"operations": 0.0, "bytes": 0.0}
    for batch in (16, 1):
        disp, raw, ratio, _, stage = edge_stage_masks(batch)
        for h, w, cin, cout, epi, (i, mk), conv in PATH_CONVS:
            x = torch.randn(batch, h, w, cin, generator=g).to(dev)
            wt = (torch.randn(3, 3, cin, cout, generator=g) * 0.05).to(dev)
            b = torch.zeros(cout, device=dev)
            m = stage[i][mk].to(dev)
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            with torch.inference_mode():
                t = time_variants({
                    "plain": lambda: tsc.conv3x3_masked_plain(
                        x, wt, b, m, "reflect", nl[epi]),
                    "conv3x3_tile_sparse": lambda: tsc.conv3x3_tile_sparse(
                        x, wt, b, m, "reflect", nl[epi]),
                    "conv3x3_tile_sparse_2d":
                        lambda: tsc.conv3x3_tile_sparse_2d(
                            x, wt, b, m, "reflect", nl[epi]),
                    "library_conv2d": lambda: F.conv2d(x_nchw, w_oihw, b,
                                                       padding=1),
                }, iters=20)
            bound, by, bound_f32 = conv_bound_ms(m, cin, cout)
            work = granule_work(m, cin, cout)
            for k in KERNELS:
                work[k]["achieved_tflops"] = (work[k]["active_flops"]
                                              / t[k]["ms_median"] / 1e9)
            reps = 2 if "pos/neg" in conv else 1
            if batch == 16:
                bound_by[by] += reps * bound
                for k in kernel_ms:
                    kernel_ms[k]["ms"] += reps * t[k]["ms_median"]
                    kernel_ms[k]["plain_ms"] += reps * t["plain"]["ms_median"]
                    kernel_ms[k]["bound_ms"] += reps * bound
                    kernel_ms[k]["bound_ms_f32_cuda_cores"] += reps * bound_f32
                    kernel_ms[k]["library_ms"] += (
                        reps * t["library_conv2d"]["ms_median"])
            emit({"phase": "time_conv", "conv": conv, "batch": batch,
                  "shape": [h, w, cin, cout],
                  "mask_density": float(m.mean()),
                  "masked_flops": 2.0 * 9 * cin * cout * float(m.sum()),
                  "bound_ms": bound, "bound_by": by,
                  "bound_ms_f32_cuda_cores": bound_f32, "granules": work,
                  **t, **_card})

        img = torch.rand(batch, H, W, 3, generator=g).to(dev)
        mo = {i: m.to(dev) for i, m in raw.items()}

        def fwd(backend, cap=0.5):
            def f():
                feats = enc(img)
                if backend is None:
                    return dec(feats)
                return dec(feats, thresh_ratio=ratio, mask_override=mo,
                           use_pallas=backend, compact_cap=cap)
            return f

        with torch.inference_mode():
            t = time_variants({"dense": fwd(None), "sparse_xla": fwd(False),
                               "sparse_pallas": fwd("pallas"),
                               "sparse_pallas2d": fwd("pallas2d"),
                               **{f"sparse_{b}": fwd(b) for b in COMPACTED},
                               # at cap 1.0 nothing overflows: xla's answer
                               **{f"sparse_{b}_cap1.0": fwd(b, 1.0)
                                  for b in ("compact", "capacity")}},
                              iters=10 if batch == 16 else 30)
        emit({"phase": "time_forward", "batch": batch, "dtype": "float32",
              "res": [H, W], "mask": "maskgen 10% edge masks",
              "compact_cap": "0.5 unless the name says 1.0",
              **{k: v for k, v in t.items()},
              "fps_median": {k: batch * 1e3 / v["ms_median"]
                             for k, v in t.items()}, **_card})
    for k in kernel_ms:
        kernel_ms[k]["bound_by"] = max(bound_by, key=bound_by.get)


def library_gather(stack, idx, th: int, window_h: int):
    """K5's yardstick: one advanced-indexing gather over an unfold view of
    the stack (windows of window_h rows every th rows)."""
    n, nw, nhp, _, twp, c = stack.shape
    view = stack.reshape(n, nw, nhp * th, twp, c).unfold(
        2, window_h, th).permute(0, 1, 2, 5, 3, 4)
    b, ty, tx = (idx[:, j].long() for j in range(3))
    return lambda: view[b, tx, ty]


def library_scatter(vals, idx, n: int, nh: int, nw: int):
    """K6's yardstick: a zeros canvas and one index_put_ into it, viewed
    as (N, nh, th, nw, tw, C)."""
    k, th, tw, c = vals.shape
    b, ty, tx = (idx[:, j].long() for j in range(3))

    def f():
        canvas = vals.new_zeros((n, nh * th, nw * tw, c))
        canvas.view(n, nh, th, nw, tw, c)[b, ty, :, tx] = vals
        return canvas
    return f


def phase_block_io_times(dev, enc, dec, dtype):
    """K5 and K6 per launch at the 18 + 6 calls of one B=16 compact
    forward (10% maskgen masks, compact_cap 0.5) in `dtype` (enc and dec
    cast to it): the kernel with its output's allocation (K6 writes all of
    its canvas), the plain version and the library call, each call's
    bytes bound; sums per forward."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = edge_stage_masks(16)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    raw = {i: m.to(dev) for i, m in raw.items()}
    calls = record_block_io(compact_forward(enc, dec, img, raw, ratio))
    sums = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bound_by": "bytes", "library_ms": 0.0}
            for name in ("band_gather", "block_scatter")}
    with torch.inference_mode():
        for k, (name, args, out) in enumerate(calls):
            if name == "band_gather":
                stack, idx, th, window_h = args
                variants = {
                    "kernel": lambda: bio._launch_gather(stack, idx,
                                                         window_h),
                    "plain": lambda: bio.band_gather_plain(*args),
                    "library": library_gather(*args)}
                # the windows read once and written once
                nbytes = size * 2.0 * out.numel() + 4.0 * idx.numel()
            else:
                vals, idx = args[:2]
                variants = {
                    "kernel": lambda: bio._launch_scatter(*args),
                    "plain": lambda: bio.block_scatter_plain(*args),
                    "library": library_scatter(*args)}
                # the tiles read once, the whole canvas written once
                nbytes = (size * (vals.numel() + out.numel())
                          + 4.0 * idx.numel())
            require(torch.equal(variants["library"](), out), (name, k))
            t = time_variants(variants, iters=20, queue_ahead=True)
            bound = nbytes / HBM_BPS * 1e3
            for key, v in (("ms", "kernel"), ("plain_ms", "plain"),
                           ("library_ms", "library")):
                sums[name][key] += t[v]["ms_median"]
            sums[name]["bound_ms"] += bound
            emit({"phase": "time_block_io", "kernel": name, "call": k,
                  "dtype": str(dtype), "batch": 16, "out": list(out.shape),
                  "bytes": nbytes, "bound_ms": bound, **t, **_card})
    emit({"phase": "time_block_io", "dtype": str(dtype),
          "per_forward_sums": sums, **_card})
    return sums


def fused_bound_ms(x, skip, yl, mask, params, flags, ht=8, tw=64):
    """(bound ms, bound by, the bound at the f32 CUDA-core rate) of one
    fused_wave_stage call: the FLOPs of its active tiles' own pixels (no
    halo) at the 3xTF32 tensor rate, or its inputs, parameters and
    outputs (yh, yl_new, x1) once at HBM rate, whichever takes longer; the
    third value puts the FLOPs at the CUDA cores' f32 peak instead."""
    cx, cs, cd = x.shape[-1], skip.shape[-1], params[0].shape[-1]
    active = float(flags.sum())
    hl, wl = ht // 2, tw // 2
    macs = (hl * wl * 9 * cx * cd
            + ht * tw * (9 * (cd + cs) * cd + 2 * cd * cd + 2 * 9 * cd * 3))
    flops = 2.0 * macs * active
    n, hh, wh = skip.shape[:3]
    nbytes = 4.0 * (x.numel() + skip.numel() + yl.numel() + mask.numel()
                    + sum(p.numel() for p in params)
                    + n * hh * wh * (3 + 4 + cd))
    t_ops, t_bytes = flops / TF32X3_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes
            else "bytes", max(flops / F32_FLOPS * 1e3, t_bytes))


def phase_fused_times(dec, inputs):
    """K2 per scale at B=16 and B=1 on the decoder's stage inputs (10%
    maskgen masks): the bare kernel on the padded inputs, its plain
    version on the same, the whole wrapper; the B=16 sums over the three
    scales (the kernels line) and the B=1 sums."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    sums = {b: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_ms_f32_cuda_cores": 0.0} for b in inputs}
    by = {"operations": 0.0, "bytes": 0.0}
    with torch.inference_mode():
        for batch, scales in inputs.items():
            for i, (x, skip, yl, mask) in scales.items():
                params = dec.stage_params(i)
                inp = fs._stage_inputs(x, skip, yl, mask, 8, 64)
                t = time_variants({
                    "kernel": lambda: fs._launch(inp, params, i, 8, 64),
                    "plain": lambda: fs.fused_wave_stage_plain(
                        inp, params, i, 8, 64),
                    "wrapper": lambda: fs.fused_wave_stage(
                        x, skip, yl, mask, *params, i_scale=i)},
                    iters=5 if batch == 16 else 20)
                bound, bound_by, bound_f32 = fused_bound_ms(
                    x, skip, yl, mask, params, inp["flags"])
                if batch == 16:
                    by[bound_by] += bound
                for key, v in (("ms", t["kernel"]["ms_median"]),
                               ("plain_ms", t["plain"]["ms_median"]),
                               ("bound_ms", bound),
                               ("bound_ms_f32_cuda_cores", bound_f32)):
                    sums[batch][key] += v
                emit({"phase": "time_fused", "scale": i, "batch": batch,
                      "x": list(x.shape), "skip": list(skip.shape),
                      "tiles": list(inp["flags"].shape),
                      "active_tiles": int(inp["flags"].sum()),
                      "bound_ms": bound, "bound_by": bound_by,
                      "bound_ms_f32_cuda_cores": bound_f32,
                      "bound_share": bound / t["kernel"]["ms_median"],
                      **t, **_card})
    emit({"phase": "time_fused", "sums_by_batch": sums, **_card})
    return {**sums[16], "bound_by": max(by, key=by.get), "library_ms": None}


# --- phase 6b: the bench twin ----------------------------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


def phase_bench(dev) -> None:
    """tools/bench.py's cells on the card (its one JSON line, re-emitted
    as {"phase": "bench", ...}): a cell whose windows spread past 10%
    after two re-measurements reports null, which is printed, not
    failed."""
    import contextlib
    import io
    from wavelet_monodepth_tpu_torch.tools import bench
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = bench.main([], device=dev)
    lines = buf.getvalue().strip().splitlines()
    require(len(lines) == 1 and json.loads(lines[0])
            == json.loads(json.dumps(result)), ("bench output", lines))
    require(set(result) == BENCH_KEYS
            and abs(result["extra"]["density"] - 0.10) < 0.01,
            ("bench result", result))
    emit({"phase": "bench", "seconds": time.perf_counter() - t0, **result})


# --- phase 7: the banded warp (K3), kernel vs plain -------------------------

TRAIN_B = 12
KITTI_FULL = (375, 1242)          # raw KITTI frame (h, w)


def stereo_grid(depth, t_x: float):
    """Normalised (N, H, W, 2) stereo grid of depth (N, H, W, 1) with the
    dataset's intrinsics at depth's size and stereo_T[0, 3] = t_x."""
    import torch
    from wavelet_monodepth_tpu_torch.ops.geometry import (backproject_depth,
                                                         project_3d)
    n, h, w, _ = depth.shape
    k = torch.eye(4, device=depth.device)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    k = k.expand(n, 4, 4)
    t = torch.eye(4, device=depth.device).repeat(n, 1, 1)
    t[:, 0, 3] = t_x
    return project_3d(backproject_depth(depth, torch.linalg.inv(k)), k, t,
                      h, w)


def band_offset(grid, valid=None) -> float:
    """max |y(pixel) - row| in pixels (before the border clip), over the
    valid pixels."""
    import torch
    h = grid.shape[1]
    y = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    off = (y - torch.arange(h, device=grid.device)[None, :, None]).abs()
    if valid is not None:
        off = off * valid
    return float(off.max())


def warp_cases(dev, models):
    """(name, img, grid) at the shapes the train step gives K3, plus a
    border clamp and ragged small shapes."""
    import torch
    from wavelet_monodepth_tpu_torch.ops.geometry import disp_to_depth
    from wavelet_monodepth_tpu_torch.ops.image import resize_bilinear
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    g = torch.Generator().manual_seed(11)
    enc, dec = models
    img = torch.rand(TRAIN_B, H, W, 3, generator=g).to(dev)
    with torch.no_grad():
        out = dec(enc(img))
    cases = []
    for s in (0, 3):                 # a loss scale, upsampled as the step does
        disp = resize_bilinear(out[("disp", s)], H, W)
        depth = disp_to_depth(disp, 0.1, 100.0)[1]
        for t_x in (0.1, -0.1):
            cases.append((f"net_disp{s}_tx{t_x:+}", img,
                          stereo_grid(depth, t_x)))
    scene = torch.from_numpy(mg.synthetic_depth_scene(
        TRAIN_B, H, W, seed=3)).to(dev)
    depth = 0.58 * W * 0.1 / (1.0 + scene * 0.03 * W)
    for t_x in (0.1, -0.1):
        cases.append((f"maskgen_scene_tx{t_x:+}", img,
                      stereo_grid(depth, t_x)))
    rows = ((torch.arange(H, device=dev) + 0.5) / H * 2.0 - 1.0)
    u = torch.full((TRAIN_B, H, W), 3.0, device=dev)
    u[::2, :, : W // 2] = -2.5
    cases.append(("border_clamp", img, torch.stack(
        [u, rows[None, :, None].expand(TRAIN_B, H, W)], -1)))
    for h, w in ((2, 70), (3, 96), (3, 70), (2, 96)):
        d = (torch.rand(2, h, w, 1, generator=g) * 30 + 1).to(dev)
        cases.append((f"ragged_{h}x{w}", torch.rand(2, h, w, 3, generator=g)
                      .to(dev), stereo_grid(d, 0.1)))
    return cases


def phase_warp_vs_plain(dev, models, errs):
    """Forward within 1e-5 and the three gradients within 1e-4 of their
    largest value (shared-memory atomics sum in a varying order), with and
    without the source-row pass; the path's grids must be row-banded."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import warp
    g = torch.Generator().manual_seed(12)
    for name, img, grid in warp_cases(dev, models):
        n, h, w, c = img.shape
        if not name.startswith(("border", "ragged")):
            off = band_offset(grid)
            require(off <= 1.0, (name, "not row-banded", off))
        x, yr = warp.banded_coords(grid, h, w)
        gout = torch.randn(img.shape, generator=g).to(dev)
        for with_src in (True, False):
            res = {}
            for kind, fn in (("kernel", warp.BandedWarp.apply),
                             ("plain", warp.banded_warp_plain)):
                src = img.clone().requires_grad_(with_src)
                xa = x.clone().requires_grad_()
                ya = yr.clone().requires_grad_()
                out = fn(src, xa, ya)
                out.backward(gout)
                res[kind] = {"out": out.detach(), "gx": xa.grad,
                             "gyr": ya.grad}
                if with_src:
                    res[kind]["gsrc"] = src.grad
            torch.cuda.synchronize()
            fwd_err = float((res["kernel"]["out"] - res["plain"]["out"])
                            .abs().max())
            grad_abs, grad_rel = {}, {}
            for k in res["plain"]:
                if k == "out":
                    continue
                d = (res["kernel"][k] - res["plain"][k]).abs().max()
                grad_abs[k] = float(d)
                grad_rel[k] = float(d / res["plain"][k].abs().max()
                                    .clamp_min(1e-30))
            require(fwd_err <= 1e-5, (name, "forward", fwd_err))
            require(all(v <= 1e-4 for v in grad_rel.values()),
                    (name, "gradients", grad_rel))
            errs["banded_warp_fwd"] = max(errs["banded_warp_fwd"], fwd_err)
            errs["banded_warp_bwd"] = max(errs["banded_warp_bwd"],
                                          *grad_abs.values())
            emit({"phase": "warp_vs_plain", "case": name,
                  "shape": [n, h, w, c], "with_src_grad": with_src,
                  "fwd_max_abs_err": fwd_err, "grad_max_abs_err": grad_abs,
                  "grad_max_rel_err": grad_rel})


# --- phase 8: the training slice ---------------------------------------------

FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


def write_kitti_mount(root: str, n: int, n_val: int, seed: int = 0) -> None:
    """A raw-KITTI-layout mount: n stereo pairs at 1242x375 JPEG made from
    maskgen scenes, the right view shifted by the scene's disparity
    (right(x) = left(x + d)), depth hints (.npy, (1, H, W)) in the same
    units as stereo_T's 0.1 baseline, invalid at the top rows and the
    right border columns, and a split "chip" (val = the first n_val
    lines)."""
    import numpy as np
    from PIL import Image
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    h, w = KITTI_FULL
    disp = mg.synthetic_depth_scene(n, h, w, seed=seed)[..., 0]
    left = (mg.scene_image(disp[..., None], seed=seed) * 255).astype(
        np.uint8)
    d_px = 1.0 + disp * 0.03 * w
    for side in ("02", "03"):
        os.makedirs(os.path.join(root, FOLDER, f"image_{side}", "data"))
        os.makedirs(os.path.join(root, "depth_hints", FOLDER,
                                 f"image_{side}"))
    lines = []
    for k in range(n):
        side = "l" if k % 2 == 0 else "r"
        src_x = np.clip(np.round(np.arange(w)[None] + d_px[k]).astype(int),
                        0, w - 1)
        right = np.take_along_axis(left[k], src_x[..., None].repeat(3, -1),
                                   axis=1)
        for sd, im in (("02", left[k]), ("03", right)):
            Image.fromarray(im).save(os.path.join(
                root, FOLDER, f"image_{sd}", "data", f"{k:010d}.jpg"),
                quality=92)
        depth = (0.58 * w * 0.1 / d_px[k]).astype(np.float32)
        depth[: h // 10] = 0.0
        depth[:, -(w // 25):] = 0.0
        np.save(os.path.join(root, "depth_hints", FOLDER,
                             "image_02" if side == "l" else "image_03",
                             f"{k:010d}.npy"), depth[None])
        lines.append(f"{FOLDER} {k} {side}")
    split = os.path.join(root, "splits", "chip")
    os.makedirs(split)
    with open(os.path.join(split, "train_files.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(split, "val_files.txt"), "w") as f:
        f.write("\n".join(lines[:n_val]) + "\n")


def train_argv(root: str, log: str, kern: str = "on", batch=TRAIN_B,
               hints: bool = True):
    """The flagship's flags (stereo + depth hints); hints=False gives the
    argmin-free variant: stereo without hints or automasking."""
    return ["--data_path", root, "--split", "chip", "--log_dir", log,
            "--batch_size", str(batch), "--height", str(H), "--width",
            str(W), "--use_stereo", "--frame_ids", "0", "--use_wavelets",
            "--weights_init", "scratch", "--stereo_warp_kernel", kern,
            "--num_epochs", "1", "--log_frequency", "250",
            "--num_workers", "4"] + (
                ["--use_depth_hints"] if hints else ["--disable_automasking"])


def phase_train_slice(dev, root: str, log: str, bf16: bool = False):
    """tools/train_kitti.main for one epoch (3 steps at B=12, one
    validation batch on the first log step), then tools/infer serves the
    checkpoint it wrote. Every K3 count starts at 0 just before main.
    bf16: with --bfloat16 (mixed precision), whose checkpoint must hold
    float32 parameters, BN statistics and Adam moments."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.tools import infer, train_kitti

    torch.cuda.synchronize()
    warp.reset_launches()
    t0 = time.perf_counter()
    summary = train_kitti.main(train_argv(root, log)
                               + (["--bfloat16"] if bf16 else []), device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(warp.launches)
    steps, vals = summary["steps"], summary["val_batches"]
    require(steps == 3 and vals == 1, summary)
    require(all(np.isfinite(v) for d in summary["losses"] for v in d.values()),
            ("finite losses", summary["losses"]))
    # each step: 4 loss scales + the hint warp forward, the 4 scale warps
    # backward (the hint warp's inputs need no gradient); validation runs
    # the forward warps once more
    require(launches == {"banded_warp_fwd": 5 * (steps + vals),
                         "banded_warp_bwd": 4 * steps}, launches)
    folder = summary["checkpoints"][-1]
    need = [os.path.join(folder, f) for f in ("encoder.pth", "depth.pth",
                                              "adam.pth")]
    require(all(os.path.isfile(f) for f in need), need)
    dtypes = set()
    for f in need:
        sd = torch.load(f, map_location="cpu", weights_only=True)
        flat = sd["state"].values() if "state" in sd else [sd]
        dtypes |= {str(v.dtype) for d in flat for v in d.values()
                   if torch.is_tensor(v) and v.is_floating_point()}
    require(dtypes == {"torch.float32"}, ("checkpoint dtypes", dtypes))
    grid_cols_off = None
    if bf16:
        # JAX's fault, reproduced: the backprojection grid in depth's dtype
        from wavelet_monodepth_tpu_torch.ops.geometry import \
            backproject_depth
        pts = backproject_depth(torch.ones(1, 1, W, 1, device=dev,
                                           dtype=torch.bfloat16),
                                torch.eye(4, device=dev)[None])
        off = (pts[0, 0] - torch.arange(W, device=dev)).abs()
        grid_cols_off = {"columns": int((off > 0).sum()),
                         "max_px": float(off.max())}
    emit({"phase": "train_main", "steps": steps, "val_batches": vals,
          "batch": TRAIN_B, "res": [H, W], "stereo_warp_kernel": "on",
          "bfloat16": bf16, "checkpoint_float_dtypes": sorted(dtypes),
          "bf16_backprojection_grid_off": grid_cols_off,
          "launches": launches, "seconds_incl_load_and_init": seconds,
          "losses": summary["losses"], "checkpoint": folder})

    args = infer.parse_args(["--image_path", root, "--torch_model_path",
                             folder, "--use_sparse", "--threshold", "0.1"])
    forward, feed = infer.load_model(args, dev, "pallas2d")
    require(feed == (H, W), feed)
    x, _ = infer.preprocess_image(os.path.join(
        root, FOLDER, "image_02", "data", f"{0:010d}.jpg"), W, H)
    out = forward(torch.from_numpy(x).to(dev), args.threshold)
    d = out[("disp", 0)]
    require(d.shape == (1, H, W, 1) and bool(torch.isfinite(d).all()),
            ("served disp", tuple(d.shape)))
    emit({"phase": "serve_trained_checkpoint", "disp_mean": float(d.mean())})
    return launches, folder


# --- phase 9: train contracts ------------------------------------------------

def loader_batch(root: str, dev, batch: int = TRAIN_B, seed: int = 0,
                 is_train: bool = True):
    """One batch of the mount through the port's dataset and loader, on
    the card."""
    from wavelet_monodepth_tpu_torch.data import kitti as kd
    from wavelet_monodepth_tpu_torch.data.loader import (parallel_batches,
                                                        to_device)
    from wavelet_monodepth_tpu_torch.data.splits import read_split
    lines = read_split("chip", "train_files.txt", root)
    ds = kd.KittiRawDataset(root, lines, H, W, [0, "s"], [0, 1, 2, 3],
                            is_train=is_train, use_depth_hints=True,
                            aug_scales=(0,), other_frame_scales=(0,),
                            device_augment=True)
    stream = parallel_batches(ds, batch, num_workers=4, seed=seed)
    try:
        return next(to_device(stream, dev))
    finally:
        stream.close()


def conditioned_state(setup, seed: int = 0):
    """Fresh seeded weights with the wavelet heads' 3x3 convs scaled by
    0.1, so no disparity reaches the clamp at 0, where
    depth = 1 / (0.01 + 9.99 disp) turns float32 rounding into 1e5-fold
    larger gradients (the CPU parity tests use the same conditioning)."""
    import torch
    state = setup.init_state(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, block in state.decoder.blocks.items():
            if "_pos" in name or "_neg" in name:
                block[2].conv.weight.mul_(0.1)
                block[2].conv.bias.mul_(0.1)
    return state


def grads_of(setup, state, batch, noise):
    """(losses, {param name: grad}, outputs) of one forward/backward, no
    update; outputs keeps the warped images and the argmin masks."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import augment
    state.optimizer.zero_grad(set_to_none=True)
    outputs, losses = setup.forward(state, augment.expand_batch(batch),
                                    noise, train=True)
    losses["loss"].backward()
    torch.cuda.synchronize()
    keep = {k: v.detach() for k, v in outputs.items()
            if k[0] in ("color", "color_depth_hint", "depth_hint_pixels",
                        "identity_selection")}
    return ({k: float(v) for k, v in losses.items()},
            {f"{p}.{n}": prm.grad.clone() for p, m in
             (("encoder", state.encoder), ("depth", state.decoder))
             for n, prm in m.named_parameters()}, keep)


def rel_norms(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
            for k in b}


def on_vs_off(dev, root: str, batch, hints: bool) -> dict:
    """Losses, gradients and outputs of "on" and "off" (and a rerun of
    each, for the run-to-run noise) on one batch and one set of weights."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
    runs = {}
    torch.backends.cudnn.deterministic = True
    for run in ("on", "off", "on2", "off2"):
        kern = "on" if run.startswith("on") else "off"
        opts = parse_kitti_args(train_argv(root, "unused", kern,
                                           hints=hints))
        setup = KittiTrainSetup(opts, steps_per_epoch=3, device=dev)
        state = conditioned_state(setup)
        noise = torch.Generator(device=dev).manual_seed(5)
        warp.reset_launches()
        runs[run] = grads_of(setup, state, batch, noise)
        runs[run + "_launches"] = dict(warp.launches)
    torch.backends.cudnn.deterministic = False
    return runs


def phase_train_contracts(dev, root: str):
    """"on" vs "off" on one batch and one set of weights, and the
    learning twin.

    The flagship loss (hints + automasking) takes elementwise argmins
    between warped images; "on" and "off" warp differently by the per-row
    vs per-pixel y (~1e-5), so ~0.1% of the argmin decisions flip and the
    two are held to that: flips <= 0.5% of pixels, losses within 1e-4
    relative; one step launches K3 exactly 5 times forward and 4 backward.
    Without hints and automasking (no argmin) the two are the same smooth
    function: losses within 1e-5, every gradient within 1e-3 of its norm
    (reruns of one variant agree to ~1e-5)."""
    # No flips and a positive baseline for every item: each warp then
    # clamps at the right border, where the hints are invalid. Where the
    # predicted-depth warp and the hint warp clamp to the same border
    # pixel, reproj and hint-reproj tie exactly and the argmin follows
    # rounding; and a hint invalid at column 0 would give its whole row
    # K3's per-row y of an invalid pixel (the JAX kernel's semantics,
    # ROADMAP.md Queue 3), which the gather does not share.
    batch = loader_batch(root, dev, is_train=False)
    batch[("stereo_T",)][:, 0, 3] = 0.1
    valid = batch[("depth_hint",)] > 0
    for hints in (True, False):
        runs = on_vs_off(dev, root, batch, hints)
        want = {"banded_warp_fwd": 5 if hints else 4, "banded_warp_bwd": 4}
        require(runs["on_launches"] == want, runs["on_launches"])
        require(not any(runs["off_launches"].values()),
                runs["off_launches"])
        (l_on, g_on, o_on), (l_off, g_off, o_off) = runs["on"], runs["off"]
        img_err = {str(k): float(((o_on[k] - o_off[k]).abs()
                                  * (valid if k[0] == "color_depth_hint"
                                     else 1.0)).max())
                   for k in o_off if k[0].startswith("color")}
        flips = {str(k): int((o_on[k] != o_off[k]).sum()) for k in o_off
                 if not k[0].startswith("color")}
        loss_rel = {k: abs(l_on[k] - l_off[k]) / max(abs(l_off[k]), 1e-30)
                    for k in l_on}
        loss_abs = max(abs(l_on[k] - l_off[k]) for k in l_on)
        rel = rel_norms(g_on, g_off)
        worst = max(rel, key=rel.get)
        emit({"phase": "contract_on_vs_off",
              "config": "stereo+hints" if hints
                        else "stereo, no hints, no automasking",
              "batch": TRAIN_B, "warped_max_abs_diff": img_err,
              "mask_flips": flips, "pixels": int(valid.numel()),
              "loss_max_abs_diff": loss_abs,
              "loss_max_rel_diff": max(loss_rel.values()),
              "grad_max_rel_norm_diff": rel[worst], "worst_tensor": worst,
              "grad_rel_norm_on_rerun": max(rel_norms(runs["on2"][1],
                                                      g_on).values()),
              "grad_rel_norm_off_rerun": max(rel_norms(runs["off2"][1],
                                                       g_off).values()),
              "launches_per_step_on": runs["on_launches"],
              "losses_on": l_on})
        if hints:
            require(max(flips.values()) <= 0.005 * valid.numel(), flips)
            require(max(loss_rel.values()) <= 1e-4, ("losses", loss_rel))
        else:
            require(loss_abs <= 1e-5, ("on vs off losses", loss_abs))
            require(rel[worst] <= 1e-3, ("on vs off gradients", worst,
                                         rel[worst]))

    for bf16 in (False, True):
        hints, dtypes = learning_contract(dev, bf16=bf16)
        emit({"phase": "contract_learns", "batch": 4, "steps": 30,
              "bfloat16": bf16, "hint_loss_first": hints[0],
              "hint_loss_last": hints[-1], "state_float_dtypes": dtypes})
        require(all(v == v for v in hints) and hints[-1] <= 0.85 * hints[0],
                ("hint loss did not fall 15%", bf16, hints[0], hints[-1]))
        require(dtypes == ["torch.float32"], ("state dtypes", dtypes))
    return batch


def twin_batch(dev, n: int = 4, shift: int = round(4 * W / 96)):
    """tests/test_training_learns.py's scene at full size: n smoothed
    random textures, the right view shifted by the test's 4 px at 96 wide
    scaled to this width (so the depth, fx * 0.1 / shift, is the test's),
    stereo_T[0, 3] = -0.1, that depth as the hint, every scale from
    area-resizing."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(0)
    tex = torch.rand(n, 3, H, 2 * W, generator=g)
    for _ in range(2):
        tex = (tex + tex.roll(1, 2) + tex.roll(1, 3)) / 3.0
    views = {"0": tex[..., :W], "s": tex[..., shift:shift + W]}
    batch = {}
    for s in range(4):
        h, w = H // 2 ** s, W // 2 ** s
        for fid, v in views.items():
            im = F.interpolate(v, size=(h, w), mode="area") if s else v
            batch[("color", fid, s)] = im.permute(0, 2, 3, 1).contiguous()
            batch[("color_aug", fid, s)] = batch[("color", fid, s)]
        k = torch.eye(4)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
        batch[("K", s)] = k.expand(n, 4, 4).contiguous()
        batch[("inv_K", s)] = torch.linalg.inv(batch[("K", s)])
    t = torch.eye(4).repeat(n, 1, 1)
    t[:, 0, 3] = -0.1
    batch[("stereo_T",)] = t
    batch[("depth_hint",)] = torch.full((n, H, W, 1), 0.58 * W * 0.1 / shift)
    batch[("depth_hint_mask",)] = torch.ones(n, H, W, 1)
    return {k: v.to(dev) for k, v in batch.items()}


def learning_contract(dev, steps: int = 30, bf16: bool = False):
    """Hint loss per step of the learning twin (B=4, "on", lr 1e-4;
    bf16: mixed precision), and the float dtypes of the parameters, BN
    buffers and Adam moments after the steps."""
    import torch
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
    opts = parse_kitti_args(train_argv("unused", "unused", "on", batch=4)
                            + (["--bfloat16"] if bf16 else []))
    setup = KittiTrainSetup(opts, steps_per_epoch=1000, device=dev)
    state = setup.init_state(torch.Generator().manual_seed(0))
    noise = torch.Generator(device=dev).manual_seed(0)
    batch = twin_batch(dev)
    hints = [float(setup.train_step(state, batch, noise)
                   ["depth_hint_loss/0"]) for _ in range(steps)]
    tensors = [t for m in (state.encoder, state.decoder)
               for t in list(m.parameters()) + list(m.buffers())]
    tensors += [v for d in state.optimizer.state.values()
                for v in d.values() if torch.is_tensor(v)]
    dtypes = sorted({str(t.dtype) for t in tensors if t.is_floating_point()})
    return hints, dtypes


# --- phase 10: training times ------------------------------------------------

def warp_bound_ms(n, h, w, c, backward: bool, with_src: bool) -> float:
    """Bytes the warp must move (each input read once, each output written
    once) at HBM rate; its ~10 flops per output value are negligible."""
    img, pix, rows = n * h * w * c, n * h * w, n * h
    if not backward:
        nbytes = 4 * (img + pix + rows + img)          # src, x, yr -> out
    else:                                  # g, src, x, yr -> gx, gyr (gsrc)
        nbytes = 4 * (img + img + pix + rows + pix + rows
                      + (img if with_src else 0))
    return nbytes / HBM_BPS * 1e3


def time_backward(out, inputs, g):
    """A call that runs only the backward of `out` (graph kept)."""
    import torch
    return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)


def trace_calls(fn, calls: int):
    """fn() `calls` times in one torch.profiler trace (its own overhead
    lengthens the wall): (device spans sorted, {kernel: [launches, us]},
    {innermost ATen op: [us, kernels]}, busy us, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_kernel, by_op = [], {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            k = by_kernel.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.end - e.time_range.start
        elif e.kernels:
            row = by_op.setdefault(e.name, [0.0, 0])
            row[0] += sum(k.duration for k in e.kernels)
            row[1] += len(e.kernels)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return spans, by_kernel, by_op, busy, wall_ms


def profile_forwards(enc, dec, dev, encb, decb) -> None:
    """Device busy time, idle share, costliest kernels and ATen ops per
    B=16 forward of each compacted backend (10% maskgen masks,
    compact_cap 0.5) and of the bench's dense and sparse (xla) cells in
    float32 and bf16 (encb, decb: the bf16 cast), 3 forwards in one trace
    each."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = edge_stage_masks(16)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    raw = {i: m.to(dev) for i, m in raw.items()}
    runs = [(b, enc, dec, img, b) for b in COMPACTED]
    for name, e, d, x in (("f32", enc, dec, img),
                          ("bf16", encb, decb, img.bfloat16())):
        runs += [(f"dense_{name}", e, d, x, None),
                 (f"sparse_xla_{name}", e, d, x, "xla")]
    for backend, e, d, x, use in runs:
        def fwd():
            with torch.inference_mode():
                if use is None:
                    d(e(x))
                else:
                    d(e(x), thresh_ratio=ratio, mask_override=raw,
                      use_pallas=use)
        fwd()
        spans, by_kernel, by_op, busy, wall_ms = trace_calls(fwd, 3)
        top_k = sorted(((v[1], n[:100], v[0]) for n, v in by_kernel.items()),
                       reverse=True)[:10]
        top_op = sorted(((v[0], n, v[1]) for n, v in by_op.items()),
                        reverse=True)[:10]
        # no device spans means the tracer saw nothing: "not measured"
        emit({"phase": "profile_forward", "backend": backend, "batch": 16,
              "forwards": 3, "kernels_per_forward": len(spans) / 3,
              "device_busy_ms_per_forward": busy / 3e3 if spans else None,
              "wall_ms_per_forward": wall_ms / 3,
              "idle_share_of_wall":
                  1.0 - busy / 1e3 / wall_ms if spans else None,
              "top_kernels_ms_per_forward": [[k, v / 3e3, c / 3]
                                             for v, k, c in top_k],
              "top_ops_ms_per_forward": [[k, v / 3e3, c / 3]
                                         for v, k, c in top_op], **_card})


def profile_step(setup, state, noise, batch, kern: str) -> None:
    """Device busy time, idle share and kernels of 3 train steps in one
    torch.profiler trace (the trace's own overhead lengthens the wall)."""
    spans, by_kernel, _, busy, wall_ms = trace_calls(
        lambda: setup.train_step(state, batch, noise), 3)
    top = sorted(((v[1], name[:120], v[0]) for name, v in by_kernel.items()),
                 reverse=True)[:12]
    warp_kernels = {name[:120]: {"launches": v[0],
                                 "us_per_launch": v[1] / v[0]}
                    for name, v in by_kernel.items()
                    if "banded_warp" in name or "grid_sampler" in name}
    # no device spans means the tracer saw nothing: "not measured" (null)
    emit({"phase": "profile_train_step", "steps": 3,
          "stereo_warp_kernel": kern, "kernels": len(spans),
          "device_busy_ms_per_step": busy / 3e3 if spans else None,
          "kernel_window_ms_per_step":
              (spans[-1][1] - spans[0][0]) / 3e3 if spans else None,
          "wall_ms_per_step": wall_ms / 3,
          "idle_share_of_wall":
              1.0 - busy / 1e3 / wall_ms if spans else None,
          "top_kernels_ms_per_step": [[k, v / 3e3, c // 3]
                                      for v, k, c in top],
          "warp_kernels": warp_kernels, **_card})


def attribute_step(setup, state, noise, batch) -> None:
    """Which ATen ops, at which input shapes, one train step's device time
    belongs to: one trace with shapes recorded, each kernel charged to the
    innermost op that launched it (and named with that op's outermost
    caller, e.g. the autograd node of a backward op)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        setup.train_step(state, batch, noise)
        torch.cuda.synchronize()
    by_op = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        root = e
        while root.cpu_parent is not None:
            root = root.cpu_parent
        row = by_op.setdefault((e.name, str(e.input_shapes)[:160],
                                root.name[:80]), [0.0, 0, {}])
        for k in e.kernels:
            row[0] += k.duration
            row[1] += 1
            row[2][k.name[:80]] = row[2].get(k.name[:80], 0.0) + k.duration
    top = sorted(by_op.items(), key=lambda kv: kv[1][0], reverse=True)[:15]
    emit({"phase": "profile_train_step_ops", "steps": 1,
          "device_ms": sum(v[0] for v in by_op.values()) / 1e3,
          "top_ops": [{"op": op, "input_shapes": shapes, "caller": caller,
                       "ms": v[0] / 1e3, "kernels": v[1],
                       "top_kernel": max(v[2], key=v[2].get)}
                      for (op, shapes, caller), v in top], **_card})


def time_costliest_conv(dev) -> None:
    """The train step's costliest op in the traces, the decoder's
    upconv_3_1 forward conv (reflect-padded input, valid 3x3 conv, cuDNN),
    alone by CUDA events: at the step's batch and at the serving cell's
    B=16, under cuDNN's heuristic choice and under cudnn.benchmark."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(31)
    w = (torch.randn(128, 256, 3, 3, generator=g) * 0.05).to(dev)
    xs = {b: torch.randn(b, 256, H // 8 + 2, W // 8 + 2, generator=g).to(dev)
          for b in (TRAIN_B, 16)}

    def benchmarked(x):
        torch.backends.cudnn.benchmark = True
        try:
            return F.conv2d(x, w)
        finally:
            torch.backends.cudnn.benchmark = False

    variants = {}
    for b, x in xs.items():
        variants[f"b{b}_heuristic"] = lambda x=x: F.conv2d(x, w)
        variants[f"b{b}_benchmark"] = lambda x=x: benchmarked(x)
    with torch.no_grad():
        t = time_variants(variants, iters=5)
    emit({"phase": "time_train_conv", "conv": "upconv_3_1 forward",
          "input": [None, 256, H // 8 + 2, W // 8 + 2],
          "weight": list(w.shape), **t, **_card})


def phase_train_times(dev, root: str, batch):
    """ms per train step (B=12, "on" vs "auto", data on the card; "on"
    again with cudnn.benchmark), a profiler trace of each for the device's
    idle share, and K3 and F.grid_sample per launch at (12, 192, 640, 3)."""
    import torch
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args

    steps = {}
    for kern in ("on", "auto", "on_bf16"):
        opts = parse_kitti_args(
            train_argv(root, "unused", kern.split("_")[0])
            + (["--bfloat16"] if kern.endswith("bf16") else []))
        setup = KittiTrainSetup(opts, steps_per_epoch=1000, device=dev)
        state = setup.init_state(torch.Generator().manual_seed(0))
        noise = torch.Generator(device=dev).manual_seed(0)
        steps[kern] = (setup, state, noise)
    t = time_variants({k: (lambda k=k: steps[k][0].train_step(
        steps[k][1], batch, steps[k][2])) for k in steps}, iters=10)
    emit({"phase": "time_train_step", "batch": TRAIN_B, "res": [H, W],
          "dtype": "float32 (on_bf16: bf16 mixed precision)", "tf32": False,
          "variants": {"on": "K3 banded warp kernel",
                       "auto": "F.grid_sample",
                       "on_bf16": "K3, --bfloat16"}, **t, **_card})

    for kern in steps:
        profile_step(*steps[kern], batch, kern)
    attribute_step(*steps["on"], batch)
    del steps
    time_costliest_conv(dev)

    # cuDNN's algorithm choice: the same "on" step with cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    opts = parse_kitti_args(train_argv(root, "unused", "on"))
    setup = KittiTrainSetup(opts, steps_per_epoch=1000, device=dev)
    state = setup.init_state(torch.Generator().manual_seed(0))
    noise = torch.Generator(device=dev).manual_seed(0)
    t = time_variants({"on_cudnn_benchmark": lambda: setup.train_step(
        state, batch, noise)}, iters=10)
    torch.backends.cudnn.benchmark = False
    emit({"phase": "time_train_step", "batch": TRAIN_B, "res": [H, W],
          "dtype": "float32", "tf32": False, **t, **_card})
    del setup, state

    # K3 and its yardsticks at the path's shape, from the path's grid. The
    # backward kernels are launched directly (the autograd engine's host
    # time per call would otherwise outrun the queued-ahead window)
    n, h, w, c = TRAIN_B, H, W, 3
    g = torch.Generator().manual_seed(21)
    img = batch[("color_u8", "s", 0)].float() / 255.0
    depth = batch[("depth_hint",)].clamp_min(1.0)
    grid = stereo_grid(depth, 0.1)
    x, yr = warp.banded_coords(grid, h, w)
    xg, yg = x.clone().requires_grad_(), yr.clone().requires_grad_()
    gout = torch.randn(n, h, w, c, generator=g).to(dev)
    out_p = warp.banded_warp_plain(img, xg, yg)
    img_nchw = img.permute(0, 3, 1, 2)
    gout_nchw = gout.permute(0, 3, 1, 2)

    def library_bwd():          # grid gradient only, as on the path
        return torch.ops.aten.grid_sampler_2d_backward(
            gout_nchw, img_nchw, grid, 0, 1, False, [False, True])

    def library_fwd_bwd():
        F.grid_sample(img_nchw, grid, padding_mode="border",
                      align_corners=False)
        return library_bwd()

    before = dict(warp.launches)
    with torch.no_grad():
        fwd = time_variants({
            "kernel": lambda: warp._launch_fwd(img, x, yr),
            # the coordinate chain in torch and the kernel: what one
            # forward warp of the step costs, against grid_sample's one
            # call on the grid
            "kernel_with_coords": lambda: warp._launch_fwd(
                img, *warp.banded_coords(grid, h, w)),
            "plain": lambda: warp.banded_warp_plain(img, x, yr),
            "library_grid_sample": lambda: F.grid_sample(
                img_nchw, grid, padding_mode="border", align_corners=False),
        }, iters=50, queue_ahead=True)
        bwd = time_variants({
            "kernel": lambda: warp._launch_bwd(img, x, yr, gout, False),
            "kernel_with_src": lambda: warp._launch_bwd(img, x, yr, gout,
                                                        True),
            "library_grid_sample": library_bwd,
        }, iters=50, queue_ahead=True)
        fwd_bwd_lib = time_variants({
            "library_grid_sample_fwd_bwd": library_fwd_bwd},
            iters=50, queue_ahead=True)
    bwd.update(time_variants({"plain": time_backward(out_p, (xg, yg), gout)},
                             iters=10))
    timed = {k: warp.launches[k] - before[k] for k in before}
    bounds = {"fwd": warp_bound_ms(n, h, w, c, False, False),
              "bwd": warp_bound_ms(n, h, w, c, True, False),
              "bwd_with_src": warp_bound_ms(n, h, w, c, True, True)}
    emit({"phase": "time_warp", "shape": [n, h, w, c],
          "fwd_band_rows": warp.band_rows(img), "fwd": fwd,
          "bwd": bwd, **fwd_bwd_lib, "bound_ms": bounds,
          "kernel_launches_while_timing": timed, **_card})
    return {"banded_warp_fwd": {
                "ms": fwd["kernel"]["ms_median"],
                "plain_ms": fwd["plain"]["ms_median"],
                "bound_ms": bounds["fwd"], "bound_by": "bytes",
                "library_ms": fwd["library_grid_sample"]["ms_median"]},
            "banded_warp_bwd": {
                "ms": bwd["kernel"]["ms_median"],
                "plain_ms": bwd["plain"]["ms_median"],
                "bound_ms": bounds["bwd"], "bound_by": "bytes",
                "library_ms": bwd["library_grid_sample"]["ms_median"]}}


# --- phase 11: the eigen-split evaluation -----------------------------------

EVAL_TEST_FRAMES = 16
# one eval configuration: (name, encoder depth, feed (h, w), weights)
EVAL_CONFIGS = (("resnet18", 18, (H, W), "trained"),
                ("resnet50", 50, (R50_H, R50_W), "seeded"))


def eval_argv(root, dev, depth, size):
    return ["--data_path", root, "--eval_stereo", "--use_wavelets",
            "--num_layers", str(depth), "--height", str(size[0]),
            "--width", str(size[1]), "--device", str(dev)]


def time_predict(argv, weights, dev, sparse: bool, profiled: bool) -> dict:
    """frames/s of kitti_eval.predict_disps over the test split (the
    second of two passes) and the share of its wall time spent in the
    host feed (JPEG decode, Lanczos resize, batching: the time the
    batches' generator takes to yield); the forward alone at B=12 on the
    card, CUDA events (median of 3 windows of 2). profiled: also one
    profiled call (kernels, device busy time, costliest kernels, ATen ops
    and convs with their shapes) and the forward under cudnn.benchmark."""
    t_start = time.perf_counter()
    import torch
    from wavelet_monodepth_tpu_torch.data.splits import readlines, \
        resolve_split_dir
    from wavelet_monodepth_tpu_torch.eval import kitti_eval
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed

    # batches of --batch_size (12): without --save_pred_disps, whose
    # coefficient stacks take one image per batch
    opts, _ = ed.parse_args([a for a in argv if a != "--save_pred_disps"])
    files = readlines(os.path.join(resolve_split_dir(
        opts.eval_split, opts.data_path), "test_files.txt"))
    forward = ed.load_forward(opts, dev, weights)
    ds = ed.eval_dataset(opts, files)
    thresh = opts.threshold if sparse else None
    for _ in range(2):
        feed = [0.0]

        def batches():
            it = ed.eval_batches(opts, ds)
            while True:
                t0 = time.perf_counter()
                b = next(it, None)
                feed[0] += time.perf_counter() - t0
                if b is None:
                    return
                yield b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disps, _ = kitti_eval.predict_disps(
            forward, batches(), device=dev, post_process=opts.post_process,
            sparse_threshold=thresh)
        wall = time.perf_counter() - t0
    x = torch.from_numpy(next(ed.eval_batches(opts, ds))).to(dev)
    fwd = time_variants({"forward": lambda: forward(x, thresh)}, iters=2)
    out = {"frames": int(disps.shape[0]),
           "frames_per_s": disps.shape[0] / wall, "seconds": wall,
           "host_feed_share": feed[0] / wall, "forward_batch": x.shape[0],
           "forward_ms": fwd["forward"]}
    if profiled:
        _, by_kernel, by_op, busy, wall_ms = trace_calls(
            lambda: forward(x, thresh), 1)
        out["forward_profile"] = {
            "kernels": sum(v[0] for v in by_kernel.values()),
            "device_busy_ms": busy / 1e3, "wall_ms": wall_ms,
            "top_kernels_us": {k[:80]: v[1] for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1][1])[:3]},
            "top_ops_us": {k: v[0] for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1][0])[:3]}}
        out["costliest_convs"] = costliest_convs(lambda: forward(x, thresh))
        # cuDNN's own algorithm search, for comparison only (the CLI
        # keeps cuDNN's heuristic choice)
        torch.backends.cudnn.benchmark = True
        try:
            out["forward_ms_cudnn_benchmark"] = time_variants(
                {"forward": lambda: forward(x, thresh)}, iters=2)["forward"]
        finally:
            torch.backends.cudnn.benchmark = False
    out["time_predict_seconds"] = time.perf_counter() - t_start
    return out


def costliest_convs(fn, top: int = 3) -> list:
    """The `top` cuDNN convolutions of one fn() by device time, with their
    input shapes (one torch.profiler trace with shapes recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::cudnn_convolution"]
    rows.sort(key=lambda e: -e.device_time_total)
    return [{"input_shapes": [list(map(int, s)) for s in e.input_shapes[:2]],
             "calls": e.count, "device_ms": e.device_time_total / 1e3}
            for e in rows[:top]]


def run_eval(argv, weights, dev, name, mode, sparse=False, timed=True):
    """evaluate_depth.main on argv (+ --torch_model_path weights), its
    row checked finite, one {"phase": "eval"} line (with time_predict's
    numbers when timed); returns main's dict."""
    import numpy as np
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed
    full = argv + (["--torch_model_path", weights] if weights else [])
    t0 = time.perf_counter()
    res = ed.main(full)
    seconds = time.perf_counter() - t0
    row = list(res["metrics"].values())
    require(all(np.isfinite(v) for v in row), (name, mode, res["metrics"]))
    if sparse:
        require(res["density_mean"] is not None
                and 0 < res["density_mean"] <= 1
                and res["total_ops_mean"] > 0, (name, mode, res))
    line = {"phase": "eval", "config": name, "mode": mode,
            "device": str(dev), "metrics": res["metrics"],
            "density": res["density_mean"],
            "gflops_per_image": (None if res["total_ops_mean"] is None
                                 else res["total_ops_mean"] / 1e9),
            "seconds": seconds}
    if timed:
        line.update(time_predict(full, weights or argv[
            argv.index("--load_weights_folder") + 1], dev, sparse,
            profiled=mode == "dense"))
    emit({**line, **_card})
    return res


def decoder_ops_mean(argv, weights, dev, thresh) -> float:
    """Mean ("total_ops", -1) over the test frames and their flips, read
    from the decoder's own outputs (not through predict_disps)."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.data.splits import readlines, \
        resolve_split_dir
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed
    opts, _ = ed.parse_args(argv)
    files = readlines(os.path.join(resolve_split_dir(
        opts.eval_split, opts.data_path), "test_files.txt"))
    forward = ed.load_forward(opts, dev, weights)
    ops = []
    for b in ed.eval_batches(opts, ed.eval_dataset(opts, files)):
        x = torch.from_numpy(b).to(dev)
        for xi in (x, torch.flip(x, dims=(2,))):
            ops += forward(xi, thresh)[("total_ops", -1)].cpu().tolist()
    return float(np.mean(ops))


def phase_eval(dev, ckpt18: str, tmp: str) -> None:
    """tools/evaluate_depth.main on a synthetic eigen mount (16 test
    frames at 1242x375, data/synth.py): KITTI ResNet18 640x192 on the
    checkpoint the training phase wrote, (a) dense --post_process, the
    same on the CPU, (b) --use_sparse --threshold 0.1 --post_process,
    (c) --bfloat16 --post_process, (d) --ext_disp_to_eval of (a)'s saved
    disparities; KITTI ResNet50 1024x320 on seeded weights, dense and
    sparse. Checks: finite rows; (d) == (a) exactly; card vs CPU
    disparities and rows within TOL; (b)'s ops are the decoder's own; (c)
    within the bf16 bounds of (a) in sigmoid disparity."""
    import shutil
    import numpy as np
    from wavelet_monodepth_tpu_torch.data import synth
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti

    t_phase = time.perf_counter()
    probe = subprocess.run([sys.executable, "-c", "import cv2"],
                           capture_output=True, timeout=120)
    root = os.path.join(tmp, "kitti_eigen")
    t0 = time.perf_counter()
    synth.fabricate(root, n_train=2, n_val=0, n_test=EVAL_TEST_FRAMES,
                    progress=False)
    emit({"phase": "eval_mount", "test_frames": EVAL_TEST_FRAMES,
          "size": KITTI_FULL, "seconds": time.perf_counter() - t0,
          "cv2_importable": probe.returncode == 0})
    split_disps = "disps_eigen_split.npy"
    for name, depth, size, weights in EVAL_CONFIGS:
        argv = eval_argv(root, dev, depth, size)
        sparse = ["--use_sparse", "--threshold", "0.1", "--post_process"]
        if weights == "seeded":
            enc, dec = build_models("cpu", seed=9, depth=depth)
            weights = os.path.join(tmp, name)
            ti.save_reference_checkpoint(weights, enc, dec, *size)
            del enc, dec
            run_eval(argv + ["--post_process"], weights, dev, name, "dense")
            run_eval(argv + sparse, weights, dev, name, "sparse", True)
            continue
        folder = os.path.join(tmp, name)
        shutil.copytree(ckpt18, folder)
        saved = os.path.join(folder, split_disps)
        disps = {}
        res = {}
        for mode, extra, run_dev in (
                ("dense", ["--post_process"], dev),
                ("dense_cpu", ["--post_process", "--device", "cpu"], "cpu"),
                ("bf16", ["--post_process", "--bfloat16"], dev)):
            res[mode] = run_eval(
                argv + extra + ["--load_weights_folder", folder,
                                "--save_pred_disps"],
                None, run_dev, name, mode, timed=mode != "dense_cpu")
            disps[mode] = np.load(saved)
            os.replace(saved, os.path.join(folder, f"{mode}.npy"))
        res["sparse"] = run_eval(argv + sparse + ["--load_weights_folder",
                                                  folder],
                                 None, dev, name, "sparse", True)
        res["ext"] = run_eval(argv + ["--ext_disp_to_eval", os.path.join(
            folder, "dense.npy")], None, dev, name, "ext_disp", timed=False)
        row = {k: list(r["metrics"].values()) for k, r in res.items()}
        cpu_gap = float(np.abs(disps["dense"] - disps["dense_cpu"]).max())
        row_gap = float(np.abs(np.subtract(row["dense"],
                                           row["dense_cpu"])).max())
        # the bf16 bounds hold the sigmoid disparity: predict_disps scales
        # it to [1 / max_depth, 1 / min_depth] = [0.01, 10]
        bf16 = np.abs(disps["bf16"] - disps["dense"]) / 9.99
        ops = decoder_ops_mean(argv + sparse, folder, dev, 0.1)
        check = {"phase": "eval_checks", "config": name,
                 "ext_row_equal": row["ext"] == row["dense"],
                 "card_vs_cpu_disp_max": cpu_gap,
                 "card_vs_cpu_row_max": row_gap,
                 "bf16_vs_f32_disp": {"max": float(bf16.max()),
                                      "mean": float(bf16.mean())},
                 "sparse_total_ops_mean": res["sparse"]["total_ops_mean"],
                 "decoder_total_ops_mean": ops}
        emit(check)
        require(check["ext_row_equal"] and cpu_gap <= TOL
                and row_gap <= TOL and bf16.max() <= BF16_DISP_MAX
                and bf16.mean() <= BF16_DISP_MEAN
                and res["sparse"]["total_ops_mean"] == ops, check)
    emit({"phase": "eval_done", "seconds": time.perf_counter() - t_phase})


# --- phase 12: NYUv2 serving and evaluation ----------------------------------

NYU_H, NYU_W = 480, 640
NYU_FRAMES = 16
NYU_B = 8
NYU_THRESH = 0.05
NYU_DENSITY = 0.05           # the published NYU operating point
# (H, W, Cin, Cout, epilogue, pad, (sparse scale, mask), conv) of the
# tile-sparse convs of one NYU sparse forward (DenseNet161, 640x480): each
# sparse scale's UpBlock convA and wave head
NYU_CONVS = [
    (60, 80, 744, 276, "leaky02", "reflect", (1, "wave"), "up2.convA"),
    (60, 80, 276, 3, "none", "zero", (1, "wavelet"), "wave2"),
    (120, 160, 372, 138, "leaky02", "reflect", (0, "wave"), "up3.convA"),
    (120, 160, 138, 3, "none", "zero", (0, "wavelet"), "wave3"),
]
# K1 / K4 launches per NYU sparse forward, JAX's routing: the convAs take
# the backend asked for, the wave heads K1 on every one of them
NYU_LAUNCHES = {
    "pallas": {"conv3x3_tile_sparse": 4, "conv3x3_tile_sparse_2d": 0},
    "pallas2d": {"conv3x3_tile_sparse": 2, "conv3x3_tile_sparse_2d": 2},
    "capacity": {"conv3x3_tile_sparse": 2, "conv3x3_tile_sparse_2d": 0},
}
# the convs each kernel runs per sparse forward on its own backend
NYU_KERNEL_CONVS = {"conv3x3_tile_sparse": ("up2.convA", "wave2",
                                            "up3.convA", "wave3"),
                    "conv3x3_tile_sparse_2d": ("up2.convA", "up3.convA")}
# the edge metrics threshold Canny maps: predictions ~1e-6 m apart flip a
# few of ~10k edge pixels and move eps by up to ~1e-3 px
NYU_EDGE_TOL = 1e-3
NYU_ROW = ("abs_rel", "rmse", "log10", "a1", "a2", "a3", "eps_acc",
           "eps_comp")


def nyu_frames(n: int, seed: int = 0):
    """n synthetic labeled frames with exact GT: the left view and true
    depth of data/synth.render_scene (KITTI's 1242x375), the view resized
    to 640x480 (bilinear, ops/resize.py), the depth x0.25 into NYU's
    range by nearest index, as the JAX package's fabricate_nyu does; GT
    edges from nyu_eval.canny on the normalised GT depth."""
    import numpy as np
    from wavelet_monodepth_tpu_torch.data import synth
    from wavelet_monodepth_tpu_torch.eval import nyu_eval
    from wavelet_monodepth_tpu_torch.ops.resize import resize_linear
    rng = np.random.RandomState(seed)
    rgb = np.empty((n, NYU_H, NYU_W, 3), np.uint8)
    depth = np.empty((n, NYU_H, NYU_W), np.float32)
    for i in range(n):
        left, _, d, _ = synth.render_scene(rng)
        img = resize_linear(left.astype(np.float32), NYU_W, NYU_H)
        rgb[i] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        yi = np.arange(NYU_H) * d.shape[0] // NYU_H
        xi = np.arange(NYU_W) * d.shape[1] // NYU_W
        depth[i] = 0.25 * d[yi][:, xi]
    edges = np.stack([nyu_eval.canny((d - d.min()) / (d.max() - d.min()))
                      for d in depth])
    return rgb, depth, edges


def nyu_model(path: str, seed: int = 10) -> None:
    """A seeded DenseNet161 + NyuDecoderWave written as a reference NYU
    model.pth, its heads rescaled so the raw output looks like depth in
    cm: the LL head's weights x3000 and bias +300 give ~1-3.5 m with a
    metre of structure from the image, the wave heads' weights x250 give
    partial masks at threshold 0.05 (a random init gives ~0.01 cm of
    structure, all-active masks and, in bf16, a constant depth)."""
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
        NyuDecoderWave
    from wavelet_monodepth_tpu_torch.models.densenet import \
        DenseNet161Encoder
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti
    g = torch.Generator().manual_seed(seed)
    enc = init_params(DenseNet161Encoder(), g)
    dec = init_params(NyuDecoderWave(enc.num_ch_enc), g)
    with torch.no_grad():
        dec.wave1_ll.conv.weight.mul_(3000.0)
        dec.wave1_ll.conv.bias.add_(300.0)
        for head in (dec.wave1, dec.wave2, dec.wave3):
            head.conv.weight.mul_(250.0)
    ti.save_nyu_model_pth(path, enc, dec)


def nyu_forward(model: str, dev, backend=False, bf16: bool = False,
                capacity_ratio: float = 0.5):
    """tools/evaluate_nyu.load_forward on the model.pth, --use_wavelets
    --use_sparse (dense without a threshold)."""
    from wavelet_monodepth_tpu_torch.tools import evaluate_nyu as ev
    argv = ["--data_path", "-", "--splits_path", "-", "--use_wavelets",
            "--use_sparse", "--device", str(dev)] + (
                ["--bfloat16"] if bf16 else [])
    return ev.load_forward(ev.nyu_options(ev.parse_args(argv)), dev, model,
                           use_pallas=backend,
                           capacity_ratio=capacity_ratio)


def nyu_input(rgb, dev):
    """predict_depth_batch's network input of uint8 frames: border-crop 16,
    /255 on the card, 640x480 align_corners resize."""
    import torch
    from wavelet_monodepth_tpu_torch.ops.image import resize_bilinear
    x = torch.from_numpy(rgb[:, 16:-16, 16:-16].copy()).to(dev)
    return resize_bilinear(x.float() / 255.0, NYU_H, NYU_W,
                           align_corners=True)


def nyu_stage_masks(raw: dict) -> dict:
    """{scale s: {"wave": convA's out mask, "wavelet": the head's}} from
    the raw masks {s: (N, h, w, 1)}, through the decoder's dilations."""
    from wavelet_monodepth_tpu_torch.ops import sparse as sp
    from wavelet_monodepth_tpu_torch.ops.image import upsample_nearest2x
    out = {}
    for s, m in raw.items():
        um = upsample_nearest2x(m)
        out[s] = {"wave": sp.dilate_mask(um, 3), "wavelet": um}
    return out


def nyu_raw_masks(batch: int, seed: int = 0):
    """Raw masks {s: (N, h, w, 1)} at the NYU decoder's sparse scales
    (s=1 at 30x40, s=0 at 60x80) from maskgen scenes at 240x320 (the
    decoder's output size), their threshold bisected so the base masks'
    density over both sparse scales (area-weighted as their wavelet
    masks, 60x80 and 120x160) is 5%; and that density."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp = mg.synthetic_depth_scene(batch, NYU_H // 2, NYU_W // 2, seed)

    def masks(r):     # maskgen's stage i masks are H / 2^(i+1)
        m = mg.dwt_stage_masks(disp, r, scales=(1, 2))
        return {1: torch.from_numpy(m[2]), 0: torch.from_numpy(m[1])}

    def density(m):
        return (4800.0 * float(m[1].mean())
                + 19200.0 * float(m[0].mean())) / 24000.0
    lo, hi = 1e-4, 1.0
    for _ in range(40):
        mid = (lo * hi) ** 0.5
        m = masks(mid)
        d = density(m)
        if abs(d - NYU_DENSITY) < 0.002:
            break
        lo, hi = (mid, hi) if d > NYU_DENSITY else (lo, mid)
    return m, d


def nyu_gap(ours: dict, ref: dict) -> float:
    """Largest |ours - ref| over the float outputs, each relative to
    max(1, max |ref|) of its tensor (the raw outputs are in cm, ~300)."""
    gap = 0.0
    for k, r in ref.items():
        if k[0] in ("wavelet_mask", "total_ops"):
            continue
        scale = max(1.0, float(r.abs().max()))
        gap = max(gap, float((ours[k] - r).abs().max()) / scale)
    return gap


def run_nyu_eval(forward, frames, dev, mode: str, thresh=None,
                 n=None, timed: bool = True) -> dict:
    """nyu_eval.evaluate at batch_size 8 with edges over the first n
    frames (all by default); one {"phase": "nyu_eval"} line with the row,
    frames/s, the host's shares of the wall time and, timed, the B=8
    forward alone (CUDA events). Returns the row."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.eval import nyu_eval
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    rgb, depth, edges = (a[:n] for a in frames)
    stats = {"density": [], "total_ops": []}

    def recorded(x, t=None):
        out = forward(x, t)
        if t is not None:
            stats["density"] += compute_density(
                out, per_image=True).cpu().tolist()
            stats["total_ops"] += out[("total_ops", -1)].cpu().tolist()
        return out
    forward(nyu_input(rgb[:1], dev), thresh)          # warm-up
    timings = {}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    row = nyu_eval.evaluate(recorded, rgb, depth, edges_gt=edges,
                            sparse_threshold=thresh, batch_size=NYU_B,
                            device=dev, timings=timings)
    wall = time.perf_counter() - t0
    require(all(np.isfinite(row[k]) for k in NYU_ROW), (mode, row))
    line = {"phase": "nyu_eval", "mode": mode, "device": str(dev),
            "frames": int(rgb.shape[0]), "threshold": thresh,
            "row": {k: float(row[k]) for k in NYU_ROW},
            "frames_per_s": rgb.shape[0] / wall, "seconds": wall,
            "predict_share": timings["predict_s"] / wall,
            "host_edges_share": timings["edges_s"] / wall}
    if thresh is not None:
        line.update(density_mean=float(np.mean(stats["density"])),
                    gflops_per_image=float(np.mean(stats["total_ops"]))
                    / 1e9)
    if timed:
        x = nyu_input(rgb[:NYU_B], dev)
        line["forward_b8"] = time_variants(
            {"forward": lambda: forward(x, thresh)}, iters=2)["forward"]
    emit({**line, **_card})
    return row


def nyu_kernel_checks(dev, errs, raw_by_batch: dict, masks: str) -> None:
    """K1 and K4 against the plain version at the four NYU conv shapes,
    on the stage masks of raw_by_batch {batch: raw masks}; <= TOL."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    nl = {"none": None, "leaky02": tsc.leaky_relu_02}
    g = torch.Generator().manual_seed(3)
    for batch, raw in raw_by_batch.items():
        stage = nyu_stage_masks({s: m.to(dev) for s, m in raw.items()})
        for h, w, cin, cout, epi, pad, (s, mk), conv in NYU_CONVS:
            m = stage[s][mk].float().contiguous()
            require(m.shape == (batch, h, w, 1), (conv, tuple(m.shape)))
            x = torch.randn(batch, h, w, cin, generator=g).to(dev)
            wt = (torch.randn(3, 3, cin, cout, generator=g)
                  * (2.0 / (9 * cin)) ** 0.5).to(dev)
            b = (torch.randn(cout, generator=g) * 0.1).to(dev)
            ref = tsc.conv3x3_masked_plain(x, wt, b, m, pad, nl[epi])
            for key in KERNELS:
                out = getattr(tsc, key)(x, wt, b, m, pad, nl[epi])
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                errs[key] = max(errs[key], err)
                emit({"phase": "kernel_vs_plain", "kernel": key,
                      "model": "nyu_densenet161", "conv": conv,
                      "masks": masks, "shape": [batch, h, w, cin, cout],
                      "pad": pad, "nonlin": epi,
                      "mask_density": float(m.mean()), "max_abs_err": err})
                require(err <= TOL, (key, conv, batch, masks, err))


def nyu_conv_times(dev, raw_by_batch: dict) -> dict:
    """Per NYU conv shape at B=8 and B=1 on the 5% masks: K1, K4, the
    plain version and cuDNN's dense F.conv2d (CUDA events, median of 3
    interleaved windows), with the conv's bound. Returns, per kernel, the
    B=8 sums over the convs it runs per sparse forward."""
    import torch
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    nl = {"none": None, "leaky02": tsc.leaky_relu_02}
    g = torch.Generator().manual_seed(4)
    sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bound_ms_f32_cuda_cores": 0.0,
                "bound_by": {"operations": 0.0, "bytes": 0.0}}
            for k in KERNELS}
    for batch, raw in raw_by_batch.items():
        stage = nyu_stage_masks({s: m.to(dev) for s, m in raw.items()})
        for h, w, cin, cout, epi, pad, (s, mk), conv in NYU_CONVS:
            m = stage[s][mk].float().contiguous()
            x = torch.randn(batch, h, w, cin, generator=g).to(dev)
            wt = (torch.randn(3, 3, cin, cout, generator=g) * 0.05).to(dev)
            b = torch.zeros(cout, device=dev)
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            with torch.inference_mode():
                t = time_variants({
                    "plain": lambda: tsc.conv3x3_masked_plain(
                        x, wt, b, m, pad, nl[epi]),
                    **{k: (lambda k=k: getattr(tsc, k)(x, wt, b, m, pad,
                                                       nl[epi]))
                       for k in KERNELS},
                    "library_conv2d": lambda: F.conv2d(x_nchw, w_oihw, b,
                                                       padding=1),
                }, iters=20)
            bound, by, bound_f32 = conv_bound_ms(m, cin, cout)
            work = granule_work(m, cin, cout)
            for k in KERNELS:
                work[k]["achieved_tflops"] = (work[k]["active_flops"]
                                              / t[k]["ms_median"] / 1e9)
                if batch == NYU_B and conv in NYU_KERNEL_CONVS[k]:
                    sums[k]["ms"] += t[k]["ms_median"]
                    sums[k]["plain_ms"] += t["plain"]["ms_median"]
                    sums[k]["bound_ms"] += bound
                    sums[k]["bound_ms_f32_cuda_cores"] += bound_f32
                    sums[k]["library_ms"] += t["library_conv2d"]["ms_median"]
                    sums[k]["bound_by"][by] += bound
            emit({"phase": "time_conv", "model": "nyu_densenet161",
                  "conv": conv, "batch": batch, "shape": [h, w, cin, cout],
                  "mask_density": float(m.mean()),
                  "masked_flops": 2.0 * 9 * cin * cout * float(m.sum()),
                  "bound_ms": bound, "bound_by": by,
                  "bound_ms_f32_cuda_cores": bound_f32, "granules": work,
                  **t, **_card})
    for k in KERNELS:
        sums[k]["bound_by"] = max(sums[k]["bound_by"],
                                  key=sums[k]["bound_by"].get)
    return sums


def nyu_requests(dev, model: str, x8, errs) -> dict:
    """One B=8 and one B=1 sparse request (threshold 0.05, the decoder's
    own masks) on pallas, pallas2d and capacity (capacity_ratio 1.0:
    nothing dropped; its overflow at JAX's 0.5 is printed), each against
    xla: the masks and op counts equal, the outputs within TOL relative
    to max(1, max |xla|) of each tensor, and JAX's K1 / K4 launches per
    forward, counted from 0 around the request. Returns the launches of
    these requests (the NYU serving path's) and the requests' raw masks
    by batch for the kernel checks."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.ops.capacity import \
        conv_capacity_overflow
    xla = nyu_forward(model, dev)
    fwds = {b: nyu_forward(model, dev, b, capacity_ratio=1.0
                           if b == "capacity" else 0.5)
            for b in NYU_LAUNCHES}
    launches = {k: 0 for k in KERNELS}
    raws = {}
    for batch in (NYU_B, 1):
        x = x8[:batch]
        ref = xla(x, NYU_THRESH)
        raws[batch] = {s: ref[("wavelet_mask", s)][:, ::2, ::2].cpu()
                       for s in (1, 0)}
        stage = nyu_stage_masks({s: m.to(dev) for s, m in
                                 raws[batch].items()})
        for backend, fwd in fwds.items():
            tsc.reset_launches()
            out = fwd(x, NYU_THRESH)
            torch.cuda.synchronize()
            got = dict(tsc.launches)
            for k in KERNELS:
                launches[k] += got[k]
            gap = nyu_gap(out, ref)
            masks_equal = all(torch.equal(out[k], ref[k]) for k in ref
                              if k[0] == "wavelet_mask")
            ops_equal = torch.equal(out[("total_ops", -1)],
                                    ref[("total_ops", -1)])
            row = {"phase": "nyu_request", "backend": backend,
                   "batch": batch, "launches": got,
                   "expected_launches": NYU_LAUNCHES[backend],
                   "gap_vs_xla_rel": gap, "masks_equal": masks_equal,
                   "total_ops_equal": ops_equal,
                   "density": [float(ref[("wavelet_mask", s)].mean())
                               for s in (1, 0)]}
            if backend == "capacity":
                row["overflow_at_0.5"] = {
                    s: int(conv_capacity_overflow(stage[s]["wave"]))
                    for s in (1, 0)}
            emit(row)
            require(got == NYU_LAUNCHES[backend] and masks_equal
                    and ops_equal and gap <= TOL, row)
        del ref
    return launches, raws


def nyu_forward_times(dev, model: str, x8, raw5: dict) -> None:
    """ms per B=8 and B=1 forward, dense and sparse on xla / pallas /
    pallas2d / capacity, the sparse scales' masks replaced by the 5%
    maskgen masks (CUDA events, median of 3 interleaved windows); then
    MobileNetV2 + NyuDecoderWave's B=8 dense and sparse (xla) forward."""
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
        NyuDecoderWave
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.mobilenetv2 import \
        MobileNetV2Encoder
    fwds = {b: nyu_forward(model, dev, b) for b in
            (False, "pallas", "pallas2d", "capacity")}
    for batch in (NYU_B, 1):
        x = x8[:batch]
        mo = {s: raw5[batch][s].to(dev) for s in (1, 0)}
        variants = {"dense": lambda: fwds[False](x, None)}
        for b, f in fwds.items():
            variants[f"sparse_{b or 'xla'}"] = (
                lambda f=f: f(x, NYU_THRESH, mask_override=mo))
        t = time_variants(variants, iters=3 if batch == NYU_B else 10)
        emit({"phase": "nyu_time_forward", "model": "densenet161",
              "batch": batch, "res": [NYU_H, NYU_W], "dtype": "float32",
              "mask": f"maskgen {NYU_DENSITY:.0%} density", **t,
              "fps_median": {k: batch * 1e3 / v["ms_median"]
                             for k, v in t.items()}, **_card})
    del fwds
    g = torch.Generator().manual_seed(12)
    enc = init_params(MobileNetV2Encoder(True), g).to(dev).eval()
    dec = init_params(NyuDecoderWave(enc.num_ch_enc), g).to(dev).eval()
    mo = {s: raw5[NYU_B][s].to(dev) for s in (1, 0)}
    with torch.inference_mode():
        t = time_variants({
            "dense": lambda: dec(enc(x8)),
            "sparse_xla": lambda: dec(enc(x8), thresh_ratio=NYU_THRESH,
                                      mask_override=mo)}, iters=5)
    emit({"phase": "nyu_time_forward", "model": "mobilenetv2",
          "batch": NYU_B, "res": [NYU_H, NYU_W], "dtype": "float32",
          "mask": f"maskgen {NYU_DENSITY:.0%} density", **t, **_card})


def nyu_profile(fn, label: str) -> None:
    """One fn() under torch.profiler: kernels, device busy time and idle
    share, the costliest kernels and ATen ops, and the costliest convs
    with their shapes."""
    import torch
    with torch.inference_mode():
        _, by_kernel, by_op, busy, wall_ms = trace_calls(fn, 1)
        convs = costliest_convs(fn, 5)
    emit({"phase": "nyu_profile_forward", "forward": label,
          "kernels": sum(v[0] for v in by_kernel.values()),
          "device_busy_ms": busy / 1e3, "wall_ms": wall_ms,
          "idle_share": 1.0 - busy / 1e3 / wall_ms,
          "top_kernels_us": {k[:80]: v[1] for k, v in sorted(
              by_kernel.items(), key=lambda kv: -kv[1][1])[:5]},
          "top_aten_ops_us": {k: v[0] for k, v in sorted(
              ((k, v) for k, v in by_op.items() if k.startswith("aten::")),
              key=lambda kv: -kv[1][0])[:5]},
          "costliest_convs": convs, **_card})


def phase_nyu(dev, errs, tmp: str) -> dict:
    """The NYUv2 slice on the card (module docstring, phase 12). Returns
    {kernel: {"launches_nyu": ..., "*_nyu": B=8 sums}} for the kernels
    line."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.eval import nyu_eval

    t_phase = time.perf_counter()
    frames = nyu_frames(NYU_FRAMES)
    model = os.path.join(tmp, "nyu", "model.pth")
    nyu_model(model)
    emit({"phase": "nyu_mount", "frames": NYU_FRAMES, "size": [NYU_H, NYU_W],
          "gt_depth_range_m": [float(frames[1].min()),
                               float(frames[1].max())],
          "seconds": time.perf_counter() - t_phase})
    f32 = nyu_forward(model, dev)
    rows = {"dense": run_nyu_eval(f32, frames, dev, "dense")}
    cpu = nyu_forward(model, torch.device("cpu"))
    two = [a[:2] for a in frames]
    rows["dense_cpu"] = run_nyu_eval(cpu, two, torch.device("cpu"),
                                     "dense_cpu", timed=False)
    rows["dense_card_2"] = run_nyu_eval(f32, two, dev, "dense_2_frames",
                                        timed=False)
    rows["sparse"] = run_nyu_eval(f32, frames, dev, "sparse_xla",
                                  thresh=NYU_THRESH)
    bf16 = nyu_forward(model, dev, bf16=True)
    rows["bf16"] = run_nyu_eval(bf16, frames, dev, "bf16")

    # card vs CPU, bf16 vs f32, thresh -1 == dense
    d_card = nyu_eval.predict_depth_batch(f32, two[0], device=dev)
    d_cpu = nyu_eval.predict_depth_batch(cpu, two[0],
                                         device=torch.device("cpu"))
    del cpu
    c = nyu_eval.EIGEN_CROP
    crop = (slice(None), slice(c[0], c[1] + 1), slice(c[2], c[3] + 1))
    pf, pb = (np.concatenate([nyu_eval.predict_depth_batch(
        f, frames[0][i:i + NYU_B], device=dev)[crop]
        for i in range(0, NYU_FRAMES, NYU_B)]) for f in (f32, bf16))
    x8 = nyu_input(frames[0][:NYU_B], dev)
    dense = f32(x8, None)
    minus1 = f32(x8, -1.0)
    gap = np.abs(pb - pf)
    check = {
        "phase": "nyu_checks",
        "card_vs_cpu_depth_max": float(np.abs(d_card - d_cpu).max()),
        "card_vs_cpu_row_max": max(float(abs(rows["dense_card_2"][k]
                                             - rows["dense_cpu"][k]))
                                   for k in NYU_ROW[:6]),
        "card_vs_cpu_eps_max": max(float(abs(rows["dense_card_2"][k]
                                             - rows["dense_cpu"][k]))
                                   for k in NYU_ROW[6:]),
        "bf16_vs_f32_depth_m": {"max": float(gap.max()),
                                "mean": float(gap.mean()),
                                "f32_mean_depth": float(pf.mean())},
        "rows": {k: {n: float(r[n]) for n in NYU_ROW}
                 for k, r in rows.items() if k in ("dense", "bf16")},
        "thresh_minus1_equals_dense": all(
            torch.equal(minus1[k], v) for k, v in dense.items()),
    }
    emit(check)
    require(check["card_vs_cpu_depth_max"] <= TOL
            and check["card_vs_cpu_row_max"] <= TOL
            and check["card_vs_cpu_eps_max"] <= NYU_EDGE_TOL
            and np.isfinite(pb).all()
            and gap.mean() <= 0.01 * pf.mean()
            and check["thresh_minus1_equals_dense"], check)
    del bf16, dense, minus1

    # the serving path's sparse requests on the kernel backends
    launches, raws = nyu_requests(dev, model, x8, errs)
    raw5 = {}
    for batch in (NYU_B, 1):
        raw5[batch], dens = nyu_raw_masks(batch)
        emit({"phase": "nyu_masks", "batch": batch,
              "aggregate_density": dens,
              "density_by_scale": {s: float(m.mean())
                                   for s, m in raw5[batch].items()}})
    nyu_kernel_checks(dev, errs, raws, "decoder threshold 0.05")
    nyu_kernel_checks(dev, errs, raw5, "maskgen 5%")
    sums = nyu_conv_times(dev, raw5)
    nyu_forward_times(dev, model, x8, raw5)
    mo = {s: m.to(dev) for s, m in raw5[NYU_B].items()}
    p2d = nyu_forward(model, dev, "pallas2d")
    for label, fn in (
            ("dense B=8", lambda: f32(x8, None)),
            ("dense B=1", lambda: f32(x8[:1], None)),
            ("sparse pallas2d B=8, 5% masks",
             lambda: p2d(x8, NYU_THRESH, mask_override=mo))):
        nyu_profile(fn, label)
    # cuDNN's own algorithm search, for comparison only (the path keeps
    # cuDNN's heuristic choice)
    torch.backends.cudnn.benchmark = True
    try:
        bench = time_variants({"dense": lambda: f32(x8, None)}, iters=2)
    finally:
        torch.backends.cudnn.benchmark = False
    emit({"phase": "nyu_time_forward", "model": "densenet161",
          "batch": NYU_B, "cudnn_benchmark": True, **bench, **_card})
    del f32, p2d
    torch.cuda.empty_cache()
    emit({"phase": "nyu_done", "seconds": time.perf_counter() - t_phase})
    return {k: {"launches_nyu": launches[k],
                **{f"{n}_nyu": v for n, v in sums[k].items()}}
            for k in KERNELS}


def main():
    dev = phase_device()
    sys.path.insert(0, REPO)
    import torch
    phase_build()
    errs = {k: 0.0 for k in KERNELS}
    errs.update(banded_warp_fwd=0.0, banded_warp_bwd=0.0, band_gather=0.0,
                block_scatter=0.0, band_gather_bf16=0.0,
                block_scatter_bf16=0.0, fused_wave_stage=0.0)
    phase_kernel_vs_plain(dev, errs)
    launches, enc, dec = phase_slice(dev)
    no_scatter_faults(dev, "slice")
    phase_contracts(dev, enc, dec)
    phase_contracts_r50(dev)
    no_scatter_faults(dev, "contracts")
    launches.update(phase_bf16_serving(dev, enc, dec))
    no_scatter_faults(dev, "bf16_serving")
    encb, decb = bf16_copies(enc, dec)
    phase_block_io_vs_plain(dev, enc, dec, errs, torch.float32)
    phase_block_io_vs_plain(dev, encb, decb, errs, torch.bfloat16)
    no_scatter_faults(dev, "block_io_vs_plain")
    phase_sync_count(dev, enc, dec)
    no_scatter_faults(dev, "sync_count")
    fused_launches, stage_ins = phase_fused_stage(dev, enc, dec, errs)
    kernel_ms = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "bound_ms_f32_cuda_cores": 0.0}
                 for k in KERNELS}
    phase_times(dev, enc, dec, kernel_ms)
    no_scatter_faults(dev, "time_forward")
    block_io_ms = phase_block_io_times(dev, enc, dec, torch.float32)
    block_io_ms_bf16 = phase_block_io_times(dev, encb, decb, torch.bfloat16)
    no_scatter_faults(dev, "time_block_io")
    fused_ms = phase_fused_times(dec, stage_ins)
    del stage_ins
    profile_forwards(enc, dec, dev, encb, decb)
    no_scatter_faults(dev, "profile_forwards")
    del encb, decb
    phase_bench(dev)
    no_scatter_faults(dev, "bench")
    # ms / plain_ms / bound_ms / library_ms: the 12 launches of one B=16
    # sparse forward at the 10% operating point, summed medians
    kernels = [{
        "name": f"tile_sparse_conv3x3 via {k}", "route": "cuda",
        "source": SOURCES["tile_sparse_conv"],
        "replaces": KERNELS[k], "launches": launches[k],
        "max_abs_err": errs[k], **kernel_ms[k]} for k in KERNELS]
    # K5 / K6: the 18 / 6 launches of one B=16 compact forward, summed;
    # launches: the 4 served requests'; the _bf16 keys: the bfloat16
    # instance, its launches those of the bf16 serving path (B=16 and B=1)
    kernels += [{
        "name": k, "route": "cuda", "source": SOURCES["blockio"],
        "replaces": BLOCKIO_REPLACES[k], "launches": launches[k],
        "max_abs_err": errs[k], **block_io_ms[k],
        "launches_bf16": launches[k + "_bf16"],
        "max_abs_err_bf16": errs[k + "_bf16"],
        **{f"{key}_bf16": v for key, v in block_io_ms_bf16[k].items()}}
        for k in BLOCKIO_REPLACES]
    # K2: its 3 scales at B=16, summed; JAX wires K2 into no decoder path,
    # so its launches are this script's own calls on the decoder's stage
    # inputs (scales 3, 2, 1 at B=16 and B=1)
    kernels.append({
        "name": "fused_wave_stage", "route": "cuda",
        "source": SOURCES["fused_wave_stage"], "replaces": FUSED_REPLACES,
        "launches": fused_launches, "max_abs_err": errs["fused_wave_stage"],
        **fused_ms,
        "note": "no JAX decoder path runs K2: launches are chip_smoke's "
                "calls on the decoder's stage inputs; library_ms is null: "
                "no single PyTorch call computes the stage"})

    phase_warp_vs_plain(dev, (enc, dec), errs)
    del enc, dec
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as tmp:
        root = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        write_kitti_mount(root, 36, TRAIN_B)
        emit({"phase": "kitti_mount", "pairs": 36, "size": KITTI_FULL,
              "seconds": time.perf_counter() - t0})
        warp_launches, ckpt = phase_train_slice(dev, root,
                                                os.path.join(tmp, "log"))
        phase_train_slice(dev, root, os.path.join(tmp, "log_bf16"),
                          bf16=True)
        batch = phase_train_contracts(dev, root)
        warp_ms = phase_train_times(dev, root, batch)
        phase_eval(dev, ckpt, tmp)
        nyu = phase_nyu(dev, errs, tmp)
    # ms: one K3 launch at (12, 192, 640, 3) (backward: the training
    # path's, no source-row pass); launches: the train main path's
    kernels += [{
        "name": k, "route": "cuda", "source": SOURCES["banded_warp"],
        "replaces": WARP_REPLACES, "launches": warp_launches[k],
        "max_abs_err": errs[k], **warp_ms[k]}
        for k in ("banded_warp_fwd", "banded_warp_bwd")]
    # K1 / K4: the NYU serving path's launches (the sparse requests of
    # phase 12) and, *_nyu, the B=8 sums over the NYU convs each runs per
    # sparse forward on its backend, at the 5% operating point
    for entry, k in zip(kernels, KERNELS):
        entry.update(nyu[k])
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
