"""Where K2's time goes: the cycles of each of its phases, on one CUDA card.

Builds a copy of `csrc/fused_wave_stage.cu` in which thread 0 of every
block reads `clock64()` before phase A and after the barrier that ends
each phase (A upconv0, B upconv1, C the 1x1 heads, D the 3x3 heads), into
the package's git-ignored `_build/`, and launches it through
`fused_stage._launch` on chip_smoke's stage inputs (a seeded random net's
decoder under the 10% maskgen masks) at scales 3/2/1, B=16 and B=1. The
kernel's ABI and arithmetic are the repo's; the copy only adds the
reads. Per scale and batch it prints one JSON line: the active blocks,
the mean and max cycles of each phase over them, and the copy's largest
difference from the plain version (the copy must still be right).

Usage, from the repo root on a machine with a card:
  python3 wavelet_monodepth_tpu_torch/tools/k2_phases.py
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PHASES = ("A_upconv0", "B_upconv1", "C_heads_1x1", "D_heads_3x3")
MAX_BLOCKS = 1 << 16


def instrument(src: str) -> str:
    """The kernel source with a clock64() read before the first phase and
    after each phase's closing barrier, and a C entry that copies them
    out."""
    lines, out, k = src.split("\n"), [], 0
    for line in lines:
        if line.startswith("  run_phase<") and k == 0:
            out += ["  long long* clk = k2_clk + (size_t)(n * n_t + t) * 5;",
                    "  if (threadIdx.x == 0) clk[0] = clock64();"]
            k = 1
        out.append(line)
        if line == "  __syncthreads();" and out[-2].startswith("  run_phase<"):
            out.append(f"  if (threadIdx.x == 0) clk[{k}] = clock64();")
            k += 1
    if k != len(PHASES) + 1:
        raise RuntimeError("the kernel's phase calls were not found")
    text = "\n".join(out).replace(
        "namespace {\n", f"__device__ long long k2_clk[{MAX_BLOCKS * 5}];\n"
        "namespace {\n", 1)
    return text.replace('extern "C" {\n', 'extern "C" {\n\n'
                        "int k2_clocks(long long* host) {\n"
                        "  return (int)cudaMemcpyFromSymbol(host, k2_clk, "
                        "sizeof(k2_clk));\n}\n", 1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_phases: needs a CUDA card")
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from wavelet_monodepth_tpu_torch.kernels import build
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "k2_phases.cu"
    lib_path = build.BUILD_DIR / "libk2_phases.so"
    src.write_text(instrument(
        (build.SRC_DIR / "fused_wave_stage.cu").read_text()))
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.k2_clocks.argtypes = [ctypes.c_void_p]
    fs._kernel_lib()                  # sets the argtypes on the repo's
    for name in ("fused_wave_stage_f32", "fused_wave_stage_smem_bytes",
                 "fused_wave_stage_error_string"):
        theirs = getattr(fs._lib, name)
        getattr(lib, name).argtypes = theirs.argtypes
        getattr(lib, name).restype = theirs.restype
    fs._lib = lib                     # ... and _launch takes the copy

    enc, dec = cs.build_models(dev)
    buf = (ctypes.c_longlong * (MAX_BLOCKS * 5))()
    with torch.inference_mode():
        for batch in (16, 1):
            stage = cs.fused_inputs(enc, dec, dev, batch)
            for i, (x, skip, yl, mask) in stage.items():
                params = dec.stage_params(i)
                inp = fs._stage_inputs(x, skip, yl, mask, 8, 64)
                if inp["flags"].numel() > MAX_BLOCKS:
                    raise ValueError("more blocks than the clock buffer")
                ours = fs._launch(inp, params, i, 8, 64)
                plain = fs.fused_wave_stage_plain(inp, params, i, 8, 64)
                err = max(float((o - p).abs().max())
                          for o, p in zip(ours, plain))
                torch.cuda.synchronize()
                if lib.k2_clocks(ctypes.addressof(buf)) != 0:
                    raise RuntimeError("k2_clocks failed")
                flags = inp["flags"].flatten().tolist()   # block order
                cyc = [[buf[b * 5 + k + 1] - buf[b * 5 + k]
                        for k in range(len(PHASES))]
                       for b, on in enumerate(flags) if on]
                print(json.dumps({
                    "phase": "k2_phases", "batch": batch, "scale": i,
                    "active_blocks": len(cyc), "card": cs.card_line(),
                    "max_abs_err_vs_plain": err,
                    "mean_cycles": {p: sum(c[k] for c in cyc) / len(cyc)
                                    for k, p in enumerate(PHASES)},
                    "max_cycles": {p: max(c[k] for c in cyc)
                                   for k, p in enumerate(PHASES)}}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
