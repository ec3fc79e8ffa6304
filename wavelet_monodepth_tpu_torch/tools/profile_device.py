"""Device profiler: a torch.profiler trace of the forward -> device time
per module.

Counterpart of `wavelet_monodepth_tpu/tools/profile_device.py`, with its
flags plus --device. JAX joins its trace to the HLO's op_name metadata
(the flax module path); here forward hooks open a `record_function`
range named by each module's path, to --depth components (e.g.
`decoder/upconv_3_1`, `encoder/layer2`), and each device kernel is
attributed to the innermost range around the op that launched it
(kernels launched outside every range go to `UNATTRIBUTED`). The
forward (KITTI ResNet + wavelet decoder, seeded weights, dense or
--threshold sparse on the decoder's default backend) runs --iters times
under the profiler after a warm-up outside it; the times are per
forward. The Chrome trace goes to --trace_dir.

On --device cpu (the tests) there is no device: `attribute` sums CPU
self time by the same ranges, and the lines say "cpu time".

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.profile_device \\
      [--height 192 --width 640 --batch 16 --num_layers 18] \\
      [--threshold 0.2] [--trace_dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import os
import tempfile

import torch
import torch.nn as nn

UNATTRIBUTED = "UNATTRIBUTED"


def module_paths(name: str, module: nn.Module) -> dict:
    """{id(submodule): (submodule, "name/child/...")}: children by
    attribute name, a child of the root named as the root folded into it
    (ResnetEncoder's torchvision body `encoder`, the KITTI decoders'
    ModuleList `decoder`: the reference's state-dict scopes), and a
    module's `blocks` dict naming its blocks (the KITTI decoders'
    upconv_3_1, waveconv_2_pos, ...)."""
    paths: dict = {}

    def walk(mod: nn.Module, path: str):
        paths.setdefault(id(mod), (mod, path))
        blocks = getattr(mod, "blocks", None)
        if isinstance(blocks, dict):
            for k, child in blocks.items():
                walk(child, f"{path}/{k}")
        for k, child in mod.named_children():
            if id(child) not in paths:
                walk(child, path if k == path else f"{path}/{k}")

    walk(module, name)
    return paths


def install_ranges(roots: dict, depth: int):
    """Forward hooks on every module of `roots` ({name: module}) whose path
    has at most `depth` components, opening a record_function range named
    by the path. Returns (hook handles, the range names)."""
    handles, names, stack = [], set(), []

    def enter(path):
        def hook(mod, args):
            rf = torch.profiler.record_function(path)
            rf.__enter__()
            stack.append(rf)
        return hook

    def leave(mod, args, out):
        stack.pop().__exit__(None, None, None)

    for name, root in roots.items():
        for mod, path in module_paths(name, root).values():
            if path.count("/") + 1 > depth:
                continue
            handles.append(mod.register_forward_pre_hook(enter(path)))
            handles.append(mod.register_forward_hook(leave))
            names.add(path)
    return handles, names


def collect_trace(fn, roots: dict, depth: int, iters: int, trace_dir: str,
                  device):
    """Run fn() `iters` times under torch.profiler with the ranges of
    install_ranges(roots, depth), after two calls outside it. Returns (the
    profiler's events, the range names, the Chrome trace's path)."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    cuda = device.type == "cuda"
    for _ in range(2):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    handles, names = install_ranges(roots, depth)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    try:
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            if cuda:
                torch.cuda.synchronize(device)
    finally:
        for h in handles:
            h.remove()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "profile_device.trace.json")
    prof.export_chrome_trace(path)
    return prof.events(), names, path


def _range_of(event, names: set) -> str:
    parent = event.cpu_parent
    while parent is not None:
        if parent.name in names:
            return parent.name
        parent = parent.cpu_parent
    return UNATTRIBUTED


def _launcher(kernel, by_id: dict):
    """The CUDA runtime call that launched a device event: the host event
    of the same correlation id named cuda* / cu*, or None. Its parents
    are the ops around the launch."""
    calls = [e for e in by_id.get(kernel.id, ())
             if e.name.startswith(("cuda", "cu"))]
    return calls[0] if calls else None


def attribute(events, names: set, iters: int = 8, device="cuda"):
    """(total ms per forward, [(range, ms per forward), ...] largest
    first); the rows sum to the total. On a CUDA device each device event
    (kernel, memcpy, memset) counts once, under the range around the
    runtime call that launched it: a range's own device-side annotation
    span carries the range's name and is no kernel. (An op's `kernels`
    list is not used: with torch 2.11 on an H100 those lists summed to
    31.7 ms per R18 B=16 forward against 19.0 ms of device busy time,
    some kernels listed on more than one op.) On the CPU each op's CPU
    self time."""
    cpu_type = torch.autograd.DeviceType.CPU
    dur = collections.Counter()
    if torch.device(device).type != "cuda":
        for e in events:
            if e.device_type == cpu_type and e.name not in names:
                dur[_range_of(e, names)] += e.self_cpu_time_total
    else:
        by_id: dict = {}
        for e in events:
            if e.device_type == cpu_type and e.name not in names:
                by_id.setdefault(e.id, []).append(e)
        for k in events:
            if k.device_type == cpu_type or k.name in names:
                continue
            host = _launcher(k, by_id)
            group = UNATTRIBUTED if host is None else _range_of(host, names)
            dur[group] += k.time_range.end - k.time_range.start
    groups = [(g, d / iters / 1e3) for g, d in dur.most_common() if d]
    return sum(dur.values()) / iters / 1e3, groups


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="device profiler")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--num_layers", type=int, default=18)
    p.add_argument("--threshold", type=float, default=None,
                   help="profile the sparse path at this threshold")
    p.add_argument("--trace_dir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "wmd_trace"))
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--depth", type=int, default=2,
                   help="module-path components per row")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def build_forward(args, dev):
    """(fwd, {"encoder": module, "decoder": module}): the profiled
    forward, seeded weights and input (seed 0) on `dev`."""
    from ..models.decoders_kitti import KittiWaveletDecoder
    from ..models.layers import init_params
    from ..models.resnet import ResnetEncoder

    gen = torch.Generator().manual_seed(0)
    encoder = init_params(ResnetEncoder(num_layers=args.num_layers), gen)
    decoder = init_params(KittiWaveletDecoder(encoder.num_ch_enc), gen)
    encoder.to(dev).eval()
    decoder.to(dev).eval()
    x = torch.rand((args.batch, args.height, args.width, 3),
                   generator=gen).to(dev)

    @torch.inference_mode()
    def fwd():
        feats = encoder(x)
        if args.threshold is None:
            return decoder(feats)[("disp", 0)]
        return decoder(feats, thresh_ratio=args.threshold)[("disp", 0)]

    return fwd, {"encoder": encoder, "decoder": decoder}


def main(argv=None, device=None) -> dict:
    """Profiles on `device`, else on --device. Returns {"total_ms",
    "groups", "trace", "device"}."""
    from ..utils import device as device_rule

    args = parse_args(argv)
    dev = device_rule.resolve_device(device if device is not None
                                     else args.device)
    device_rule.pin_float32(dev)
    fwd, roots = build_forward(args, dev)
    events, names, trace = collect_trace(fwd, roots, args.depth, args.iters,
                                         args.trace_dir, dev)
    total, groups = attribute(events, names, args.iters, dev)
    kind = "device" if dev.type == "cuda" else "cpu"
    print(f"total {kind} time: {total:.3f} ms/eval "
          f"({total / args.batch * 1e3:.1f} us/frame), trace: {trace}")
    for g, ms in groups:
        if ms < 0.005:
            continue
        print(f"{ms:8.3f} ms/eval  {g}")
    return {"total_ms": total, "groups": groups, "trace": trace,
            "device": kind}


if __name__ == "__main__":
    main()
