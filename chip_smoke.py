#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Drives wavelet_monodepth_tpu_torch's two paths at full width (KITTI
ResNet18, 640x192, random weights from seeded torch.Generators): serving
(dense and sparse inference, the tile-sparse 3x3 conv kernel) and
training (stereo + depth hints at batch 12 with the banded warp kernel),
in phases; any failure raises and exits non-zero:

  1. device: needs CUDA (raises otherwise), turns TF32 off, prints the
     card's name and power limit;
  2. build: both csrc/*.cu sources, one nvcc each, started together;
     prints each one's ptxas registers and spills;
  3. conv kernel vs plain: both wrappers (stripe flags, K1; 2-D tile
     flags, K4) against the plain PyTorch version at every decoder conv
     shape of the path at B=1 and B=16, plus all pad modes / epilogues and
     all-zero, all-one and ragged masks; max |err| <= 1e-4;
  4. serving: a reference-layout checkpoint folder and 4 scene PNGs are
     written to a temp dir, and a server built by tools/infer.load_model
     answers each image with --use_sparse --threshold 0.1 on both kernel
     backends (12 launches per request each, counted), checked against
     the masked-dense cuDNN backend; then tools/infer.main runs once;
  5. serving contracts: thresh=-1 sparse == dense (bitwise on the xla
     backend, 1e-4 on the kernel backends) and, at bench.py's operating
     point (B=16, 10% edge masks via mask_override), kernel backends ==
     xla within 1e-4 with equal op counts;
  6. serving times (CUDA events, warm-up, median of 3 interleaved windows
     with min and max): per-conv kernel vs plain vs cuDNN's F.conv2d with
     each conv's bound, whole forward dense vs sparse xla / pallas /
     pallas2d at B=16 and B=1;
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
     tools/infer then serves;
  9. training contracts: "on" vs "off" on one batch and one set of
     weights: without hints and automasking (no argmin) losses within
     1e-5 and every gradient within 1e-3 of its norm; with them (the
     flagship, whose argmins flip where the two warps differ by ~1e-5)
     <= 0.5% of the mask pixels flipped and losses within 1e-4
     relative; one step launches K3 exactly 5 + 4 times; and the hint
     loss of a 640x192 B=4 batch falls by >= 15% in 30 steps;
 10. training times: ms per train step at B=12, "on" vs "auto", data on
     the card; a torch.profiler trace of each (device idle share) and
     one of an "on" step with input shapes (device time by ATen op);
     its costliest op, a decoder conv, alone (B=12 and B=16, cuDNN's
     heuristic vs benchmark); K3
     forward and backward per launch against the plain version,
     F.grid_sample and their bound.

stdout: one JSON object per line (the card's nvidia-smi line and the
CLIs' progress lines aside); the line before the last is the kernels
summary and the last is {"ok": true, "device": {...}}.

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
KERNELS = {
    "conv3x3_tile_sparse": "wavelet_monodepth_tpu/ops/pallas_conv.py:124",
    "conv3x3_tile_sparse_2d": "wavelet_monodepth_tpu/ops/pallas_conv.py:274",
}
SOURCES = {"tile_sparse_conv":
           "wavelet_monodepth_tpu_torch/csrc/tile_sparse_conv.cu",
           "banded_warp": "wavelet_monodepth_tpu_torch/csrc/banded_warp.cu"}
WARP_REPLACES = "wavelet_monodepth_tpu/ops/warp.py:205"
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s
# and float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12

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
    """Both sources, one nvcc each, started together."""
    from wavelet_monodepth_tpu_torch.kernels import build
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.ops import warp
    t0 = time.perf_counter()
    build.load_all(list(SOURCES))
    tsc._kernel_lib()
    warp._kernel_lib()
    for name in SOURCES:
        info = build.build_info[name]
        usage = [ln.split("info    :")[-1].strip()
                 for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "source": SOURCES[name],
              "nvcc_seconds": info["seconds"], "ptxas": usage})
    emit({"phase": "build", "seconds": time.perf_counter() - t0})


# --- phase 3: kernel vs plain ----------------------------------------------

def edge_stage_masks(batch, seed=0):
    """{scale i: stage_masks(...)} of the 10% maskgen operating point, and
    the raw masks, on the CPU."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import sparse as sp
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp = mg.synthetic_depth_scene(batch, H, W, seed=seed)
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

    for batch in (1, 16):
        _, _, _, _, stage = edge_stage_masks(batch)
        for h, w, cin, cout, epi, (i, mk), conv in PATH_CONVS:
            m = stage[i][mk].to(dev)
            require(m.shape == (batch, h, w, 1), (conv, m.shape))
            check({"conv": conv, "shape": [batch, h, w, cin, cout],
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

def build_models(dev, seed=0):
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
        KittiWaveletDecoder
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
    gen = torch.Generator().manual_seed(seed)
    enc = init_params(ResnetEncoder(18), gen)
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
    for backend in ("pallas", "pallas2d", "xla"):
        servers[backend], feed = infer.load_model(args, dev, backend)
        require(feed == (H, W), feed)

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
    answers = []
    for x in requests:
        per = {}
        for backend, key in (("pallas", "conv3x3_tile_sparse"),
                             ("pallas2d", "conv3x3_tile_sparse_2d")):
            before = tsc.launches[key]
            per[backend] = servers[backend](x, args.threshold)
            per[backend + "_launches"] = tsc.launches[key] - before
        answers.append(per)
    torch.cuda.synchronize()
    launches = dict(tsc.launches)

    for k, (x, per) in enumerate(zip(requests, answers)):
        ref = servers["xla"](x, args.threshold)
        for backend in ("pallas", "pallas2d"):
            require(per[backend + "_launches"] == 12,
                    ("launches per request", backend, per))
            err, flips = same_answer(per[backend], ref, args.threshold,
                                     rerun(x))
            emit({"phase": "slice", "request": k, "backend": backend,
                  "launches": per[backend + "_launches"],
                  "disp_max_abs_err_vs_xla": err, "mask_flips": flips,
                  "density": float(compute_density(per[backend]))})
    require(launches == {"conv3x3_tile_sparse": 48,
                         "conv3x3_tile_sparse_2d": 48}, launches)

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
    """(bound ms, bound by) of one masked 3x3 conv: the FLOPs of its
    active outputs at the f32 CUDA-core peak, or the bytes it must move
    (the input pixels those outputs read, weights, mask, the whole
    output) at HBM rate, whichever takes longer."""
    import torch.nn.functional as F
    n, h, w, _ = m.shape
    active = float(m.sum())
    needed = float(F.max_pool2d(m.permute(0, 3, 1, 2), 3, 1, 1).sum())
    flops = 2.0 * 9 * cin * cout * active
    nbytes = 4.0 * (needed * cin + 9 * cin * cout + cout + n * h * w
                    + n * h * w * cout)
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


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
            bound, by = conv_bound_ms(m, cin, cout)
            reps = 2 if "pos/neg" in conv else 1
            if batch == 16:
                bound_by[by] += reps * bound
                for k in kernel_ms:
                    kernel_ms[k]["ms"] += reps * t[k]["ms_median"]
                    kernel_ms[k]["plain_ms"] += reps * t["plain"]["ms_median"]
                    kernel_ms[k]["bound_ms"] += reps * bound
                    kernel_ms[k]["library_ms"] += (
                        reps * t["library_conv2d"]["ms_median"])
            emit({"phase": "time_conv", "conv": conv, "batch": batch,
                  "shape": [h, w, cin, cout],
                  "mask_density": float(m.mean()), "bound_ms": bound,
                  "bound_by": by, **t, **_card})

        img = torch.rand(batch, H, W, 3, generator=g).to(dev)
        mo = {i: m.to(dev) for i, m in raw.items()}

        def fwd(backend):
            def f():
                feats = enc(img)
                if backend is None:
                    return dec(feats)
                return dec(feats, thresh_ratio=ratio, mask_override=mo,
                           use_pallas=backend)
            return f

        with torch.inference_mode():
            t = time_variants({"dense": fwd(None), "sparse_xla": fwd(False),
                               "sparse_pallas": fwd("pallas"),
                               "sparse_pallas2d": fwd("pallas2d")},
                              iters=10 if batch == 16 else 30)
        emit({"phase": "time_forward", "batch": batch, "dtype": "float32",
              "res": [H, W], "mask": "maskgen 10% edge masks",
              **{k: v for k, v in t.items()},
              "fps_median": {k: batch * 1e3 / v["ms_median"]
                             for k, v in t.items()}, **_card})
    for k in kernel_ms:
        kernel_ms[k]["bound_by"] = max(bound_by, key=bound_by.get)


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


def phase_train_slice(dev, root: str, log: str):
    """tools/train_kitti.main for one epoch (3 steps at B=12, one
    validation batch on the first log step), then tools/infer serves the
    checkpoint it wrote. Every K3 count starts at 0 just before main."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.tools import infer, train_kitti

    torch.cuda.synchronize()
    warp.reset_launches()
    t0 = time.perf_counter()
    summary = train_kitti.main(train_argv(root, log), device=dev)
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
    emit({"phase": "train_main", "steps": steps, "val_batches": vals,
          "batch": TRAIN_B, "res": [H, W], "stereo_warp_kernel": "on",
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
    return launches


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

    hints = learning_contract(dev)
    emit({"phase": "contract_learns", "batch": 4, "steps": 30,
          "hint_loss_first": hints[0], "hint_loss_last": hints[-1]})
    require(all(v == v for v in hints) and hints[-1] <= 0.85 * hints[0],
            ("hint loss did not fall 15%", hints[0], hints[-1]))
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


def learning_contract(dev, steps: int = 30):
    """Hint loss per step of the learning twin (B=4, "on", lr 1e-4)."""
    import torch
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
    opts = parse_kitti_args(train_argv("unused", "unused", "on", batch=4))
    setup = KittiTrainSetup(opts, steps_per_epoch=1000, device=dev)
    state = setup.init_state(torch.Generator().manual_seed(0))
    noise = torch.Generator(device=dev).manual_seed(0)
    batch = twin_batch(dev)
    return [float(setup.train_step(state, batch, noise)["depth_hint_loss/0"])
            for _ in range(steps)]


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


def profile_step(setup, state, noise, batch, kern: str) -> None:
    """Device busy time, idle share and kernels of 3 train steps in one
    torch.profiler trace (the trace's own overhead lengthens the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            setup.train_step(state, batch, noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_kernel = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            k = by_kernel.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.end - e.time_range.start
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
    for kern in ("on", "auto"):
        opts = parse_kitti_args(train_argv(root, "unused", kern))
        setup = KittiTrainSetup(opts, steps_per_epoch=1000, device=dev)
        state = setup.init_state(torch.Generator().manual_seed(0))
        noise = torch.Generator(device=dev).manual_seed(0)
        steps[kern] = (setup, state, noise)
    t = time_variants({k: (lambda k=k: steps[k][0].train_step(
        steps[k][1], batch, steps[k][2])) for k in steps}, iters=10)
    emit({"phase": "time_train_step", "batch": TRAIN_B, "res": [H, W],
          "dtype": "float32", "tf32": False,
          "variants": {"on": "K3 banded warp kernel",
                       "auto": "F.grid_sample"}, **t, **_card})

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
    emit({"phase": "time_warp", "shape": [n, h, w, c], "fwd": fwd,
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


def main():
    dev = phase_device()
    sys.path.insert(0, REPO)
    import torch
    phase_build()
    errs = {k: 0.0 for k in KERNELS}
    errs.update(banded_warp_fwd=0.0, banded_warp_bwd=0.0)
    phase_kernel_vs_plain(dev, errs)
    launches, enc, dec = phase_slice(dev)
    phase_contracts(dev, enc, dec)
    kernel_ms = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0} for k in KERNELS}
    phase_times(dev, enc, dec, kernel_ms)
    # ms / plain_ms / bound_ms / library_ms: the 12 launches of one B=16
    # sparse forward at the 10% operating point, summed medians
    kernels = [{
        "name": f"tile_sparse_conv3x3 via {k}", "route": "cuda",
        "source": SOURCES["tile_sparse_conv"],
        "replaces": KERNELS[k], "launches": launches[k],
        "max_abs_err": errs[k], **kernel_ms[k]} for k in KERNELS]

    phase_warp_vs_plain(dev, (enc, dec), errs)
    del enc, dec
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as tmp:
        root = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        write_kitti_mount(root, 36, TRAIN_B)
        emit({"phase": "kitti_mount", "pairs": 36, "size": KITTI_FULL,
              "seconds": time.perf_counter() - t0})
        warp_launches = phase_train_slice(dev, root, os.path.join(tmp, "log"))
        batch = phase_train_contracts(dev, root)
        warp_ms = phase_train_times(dev, root, batch)
    # ms: one K3 launch at (12, 192, 640, 3) (backward: the training
    # path's, no source-row pass); launches: the train main path's
    kernels += [{
        "name": k, "route": "cuda", "source": SOURCES["banded_warp"],
        "replaces": WARP_REPLACES, "launches": warp_launches[k],
        "max_abs_err": errs[k], **warp_ms[k]}
        for k in ("banded_warp_fwd", "banded_warp_bwd")]
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
