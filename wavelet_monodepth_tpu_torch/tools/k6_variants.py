"""Variants of the tile scatter kernel (K6, `csrc/blockio.cu`) timed on the
6 block_scatter calls of one B=16 compact forward, on one CUDA card.

Each variant is a copy of the source with a few macros set at build time
(nvcc `-D`, all builds started together):

  SCT=n   threads per block (512)        SCU=n  units per thread per step (4)
  WB=1    write-back stores in place of streaming ones (st.global.cs)
  LCS=1   streaming loads (ld.global.cs) of the tiles
  BYU=1   size the grid by threads x units, not by threads, where a
          canvas is smaller than the card's resident blocks cover
  BPS=n   at most n resident blocks per SM

The calls are recorded from chip_smoke.py's compact forward (10% maskgen
masks, compact_cap 0.5, a seeded random net) in float32 and bf16. Per
call each variant (its canvas's allocation and the kernel) must equal
the recorded output; then every variant, the kernel with no idx row
(zeros only), a fill of the canvas (`zero_`) and a copy of it
(`copy_`) are timed as chip_smoke times K6: 20 calls queued behind a
device-side sleep, median of 3 interleaved windows. One JSON line per
call, then the sums over the 6 calls per dtype.

Usage, from the repo root on a machine with a card:
  python3 wavelet_monodepth_tpu_torch/tools/k6_variants.py \\
      '{"base": {}, "write_back": {"WB": 1}, "u2": {"SCU": 2}}'
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (text of csrc/blockio.cu, its macro-guarded replacement)
PATCHES = [
    ("constexpr int SCATTER_THREADS = 512;",
     "constexpr int SCATTER_THREADS = SCT;"),
    ("constexpr int SCATTER_UNROLL = 4;",
     "constexpr int SCATTER_UNROLL = SCU;"),
    ("if (g < total) __stcs(&out[g], v[u]);",
     "if (g < total) { if (WB) out[g] = v[u]; "
     "else __stcs(&out[g], v[u]); }"),
    ("v[u] = vals[((size_t)k * th + (q - tr * th)) * len + (g - s * len)];",
     "{ const U* p = &vals[((size_t)k * th + (q - tr * th)) * len"
     " + (g - s * len)]; v[u] = LCS ? __ldcs(p) : *p; }"),
    ("std::min<size_t>((size_t)per_sm * sms,",
     "std::min<size_t>((size_t)std::min(per_sm, BPS) * sms,"),
    ("(total + SCATTER_THREADS - 1) / SCATTER_THREADS));",
     "(total + SCATTER_THREADS * (BYU ? SCATTER_UNROLL : 1) - 1)"
     " / (SCATTER_THREADS * (BYU ? SCATTER_UNROLL : 1))));"),
]
DEFAULTS = {"SCT": 512, "SCU": 4, "WB": 0, "LCS": 0, "BYU": 0, "BPS": 64}


def build_variants(variants: dict) -> dict:
    """{name: ctypes library} of the patched source, one nvcc each."""
    from wavelet_monodepth_tpu_torch.kernels import build
    src = (build.SRC_DIR / "blockio.cu").read_text()
    for old, new in PATCHES:
        if old not in src:
            raise RuntimeError(f"csrc/blockio.cu no longer holds {old!r}")
        src = src.replace(old, new)
    out_dir = build.BUILD_DIR / "k6_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "blockio_variants.cu"
    path.write_text(src)
    jobs = {}
    for name, macros in variants.items():
        flags = [f"-D{k}={v}" for k, v in {**DEFAULTS, **macros}.items()]
        lib = out_dir / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(path)], stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        print(json.dumps({"variant": name, "macros": variants[name],
                          "ptxas": [ln.split("info    :")[-1].strip()
                                    for ln in err.splitlines()
                                    if "scatter" in ln or "Used" in ln]}),
              flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        for suffix in ("f32", "bf16"):
            fn = getattr(libs[name], f"block_scatter_{suffix}")
            fn.argtypes = [p] * 4 + [i] * 8 + [p]
            fn.restype = i
    return libs


def time_call(cs, libs, args, ref, faults) -> dict:
    """Every variant, the zeros-only kernel, fill and copy on one call."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    vals, idx, n, nh, nw = args
    k, th, tw, c = vals.shape
    suffix = bio.KERNEL_DTYPES[vals.dtype]

    def launch(lib, rows):
        def f():
            out = torch.empty_like(ref)
            err = getattr(lib, f"block_scatter_{suffix}")(
                vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
                faults.data_ptr(), rows, n, nh, nw, th, tw, c,
                ref.device.index,
                torch.cuda.current_stream(ref.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"variant launch failed: {err}")
            return out
        return f

    variants = {name: launch(lib, k) for name, lib in libs.items()}
    for name, f in variants.items():
        if not torch.equal(f(), ref):
            raise RuntimeError(f"variant {name} differs from the kernel")
    canvas, source = torch.empty_like(ref), ref.clone()
    variants.update(
        zeros_only=launch(next(iter(libs.values())), 0),
        fill=lambda: canvas.zero_(), copy=lambda: canvas.copy_(source))
    with torch.inference_mode():
        t = cs.time_variants(variants, iters=20, queue_ahead=True)
    return {name: v["ms_median"] for name, v in t.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    dev = cs.phase_device()
    libs = build_variants(json.loads(argv[0]))
    enc, dec = cs.build_models(dev)
    disp, raw, ratio, _, _ = cs.edge_stage_masks(16)
    raw = {i: m.to(dev) for i, m in raw.items()}
    faults = torch.zeros(1, dtype=torch.int32, device=dev)
    sums = {}
    for dtype, (e, d) in ((torch.float32, (enc, dec)),
                          (torch.bfloat16, cs.bf16_copies(enc, dec))):
        img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev, dtype)
        calls = [(args, out) for name, args, out in cs.record_block_io(
            cs.compact_forward(e, d, img, raw, ratio))
            if name == "block_scatter"]
        total = {}
        for k, (args, ref) in enumerate(calls):
            vals, idx = args[:2]
            nbytes = (vals.element_size() * (vals.numel() + ref.numel())
                      + 4.0 * idx.numel())
            row = {"bound_ms": nbytes / cs.HBM_BPS * 1e3,
                   **time_call(cs, libs, args, ref, faults)}
            for key, v in row.items():
                total[key] = total.get(key, 0.0) + v
            print(json.dumps({"dtype": str(dtype), "call": k,
                              "out": list(ref.shape), "K": len(idx), **row}),
                  flush=True)
        sums[str(dtype)] = total
    if int(faults.item()) != 0:
        raise RuntimeError(f"the variants counted {int(faults.item())} faults")
    print(json.dumps({"sums": sums, "card": cs.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
