#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Drives wavelet_monodepth_tpu_torch's serving path at full width (KITTI
ResNet18, 640x192, random weights from a seeded torch.Generator) and its
hand-written tile-sparse 3x3 conv kernel, in phases; any failure raises
and exits non-zero:

  1. device: needs CUDA (raises otherwise), turns TF32 off, prints the
     card's name and power limit;
  2. build: nvcc-builds csrc/tile_sparse_conv.cu, prints the seconds;
  3. kernel vs plain: both wrappers (stripe flags, K1; 2-D tile flags, K4)
     against the plain PyTorch version at every decoder conv shape of the
     path at B=1 and B=16, plus all pad modes / epilogues and all-zero,
     all-one and ragged masks; max |err| <= 1e-4;
  4. slice: a reference-layout checkpoint folder and 4 scene PNGs are
     written to a temp dir, and a server built by tools/infer.load_model
     answers each image with --use_sparse --threshold 0.1 on both kernel
     backends (12 launches per request each, counted), checked against
     the masked-dense cuDNN backend; then tools/infer.main runs once;
  5. contracts: thresh=-1 sparse == dense (bitwise on the xla backend,
     1e-4 on the kernel backends) and, at bench.py's operating point
     (B=16, 10% edge masks via mask_override), kernel backends == xla
     within 1e-4 with equal op counts;
  6. times (CUDA events, warm-up, median of 3 interleaved windows with
     min and max): per-conv kernel vs plain, whole forward dense vs
     sparse xla / pallas / pallas2d at B=16 and B=1.

stdout: one JSON object per line (the card's nvidia-smi line and infer's
progress lines aside); the line before the last is the kernels summary
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
KERNELS = {
    "conv3x3_tile_sparse": "wavelet_monodepth_tpu/ops/pallas_conv.py:124",
    "conv3x3_tile_sparse_2d": "wavelet_monodepth_tpu/ops/pallas_conv.py:274",
}

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
    from wavelet_monodepth_tpu_torch.kernels import build
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    t0 = time.perf_counter()
    tsc._kernel_lib()
    info = build.build_info["tile_sparse_conv"]
    usage = [ln.split("info    :")[-1].strip()
             for ln in info["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "ptxas": usage})


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

def time_variants(variants: dict, iters: int, windows: int = 3) -> dict:
    """ms per call of each variant: warm-up, then `windows` windows of
    `iters` calls timed with CUDA events, interleaved (a, b, b, a, ...)."""
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
            start.record()
            for _ in range(iters):
                variants[k]()
            end.record()
            end.synchronize()
            ms[k].append(start.elapsed_time(end) / iters)
    return {k: {"ms_median": statistics.median(v), "ms_min": min(v),
                "ms_max": max(v)} for k, v in ms.items()}


def phase_times(dev, enc, dec, kernel_ms):
    """Adds to kernel_ms the B=16 per-forward sums (12 launches)."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    g = torch.Generator().manual_seed(2)
    nl = {"elu": tsc.elu, "sigmoid": tsc.sigmoid}
    for batch in (16, 1):
        disp, raw, ratio, _, stage = edge_stage_masks(batch)
        for h, w, cin, cout, epi, (i, mk), conv in PATH_CONVS:
            x = torch.randn(batch, h, w, cin, generator=g).to(dev)
            wt = (torch.randn(3, 3, cin, cout, generator=g) * 0.05).to(dev)
            b = torch.zeros(cout, device=dev)
            m = stage[i][mk].to(dev)
            with torch.inference_mode():
                t = time_variants({
                    "plain": lambda: tsc.conv3x3_masked_plain(
                        x, wt, b, m, "reflect", nl[epi]),
                    "conv3x3_tile_sparse": lambda: tsc.conv3x3_tile_sparse(
                        x, wt, b, m, "reflect", nl[epi]),
                    "conv3x3_tile_sparse_2d":
                        lambda: tsc.conv3x3_tile_sparse_2d(
                            x, wt, b, m, "reflect", nl[epi]),
                }, iters=20)
            reps = 2 if "pos/neg" in conv else 1
            if batch == 16:
                for k in kernel_ms:
                    kernel_ms[k]["ms"] += reps * t[k]["ms_median"]
                    kernel_ms[k]["plain_ms"] += reps * t["plain"]["ms_median"]
            emit({"phase": "time_conv", "conv": conv, "batch": batch,
                  "shape": [h, w, cin, cout],
                  "mask_density": float(m.mean()), **t, **_card})

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


def main():
    dev = phase_device()
    sys.path.insert(0, REPO)
    import torch
    phase_build()
    errs = {k: 0.0 for k in KERNELS}
    phase_kernel_vs_plain(dev, errs)
    launches, enc, dec = phase_slice(dev)
    phase_contracts(dev, enc, dec)
    kernel_ms = {k: {"ms": 0.0, "plain_ms": 0.0} for k in KERNELS}
    phase_times(dev, enc, dec, kernel_ms)
    # ms / plain_ms: the 12 launches of one B=16 sparse forward at the
    # 10% operating point, kernel vs plain version, summed medians
    summary = {"kernels": [{
        "name": f"tile_sparse_conv3x3 via {k}", "route": "cuda",
        "source": "wavelet_monodepth_tpu_torch/csrc/tile_sparse_conv.cu",
        "replaces": KERNELS[k], "launches": launches[k],
        "max_abs_err": errs[k], **kernel_ms[k]} for k in KERNELS]}
    print(card_line(), flush=True)
    emit(summary)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
