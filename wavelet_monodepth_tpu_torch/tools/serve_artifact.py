"""Run a `torch.export` serving artifact over images: the serving half of
`tools/export_serving.py`, without the model-building Python.

Counterpart of `wavelet_monodepth_tpu/tools/serve_artifact.py`, with its
flags plus --device. It loads `<artifact>.pt2` and the state dict of
`<artifact>.params.pt` into the program with `strict=True`, decodes the
images to the artifact's feed size (the native threaded decoder of
`data/native_loader.py` when it builds, PIL's LANCZOS otherwise; it
prints which fed the run), batches them (the tail batch padded with its
last image: the shapes are static), and writes `<stem>_disp.npy` of
disp[i, :, :, 0] per image (the `test_simple.py` output contract).
Images ship uint8 when the artifact was exported with --uint8_input.
It imports nothing of the port's models.

The artifact runs on the device it was exported on (its .json's
`platforms`); --device must name that device type. TF32 is turned off
here (`utils/device.pin_float32`): the artifact does not carry the flag.

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.serve_artifact \\
      --artifact /tmp/r18_640x192 --images 'imgs/*.jpg' --out preds/ \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="run a serving artifact")
    p.add_argument("--artifact", type=str, required=True,
                   help="path prefix from export_serving (reads "
                        ".pt2/.json/.params.pt)")
    p.add_argument("--images", type=str, required=True,
                   help="image path, glob, or directory")
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default: next to each image)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def _resolve_images(spec: str):
    if os.path.isdir(spec):
        paths = sorted(
            p for p in glob.glob(os.path.join(spec, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png")))
    else:
        paths = sorted(glob.glob(spec)) if any(
            c in spec for c in "*?[") else [spec]
    if not paths:
        raise FileNotFoundError(f"no images match {spec!r}")
    return paths


def _decode(paths, height, width, num_workers):
    """(uint8 NHWC batch, the feed that decoded it): the native threaded
    decoder when it builds, PIL's LANCZOS otherwise."""
    from ..data import native_loader as nl
    if nl.available():
        return nl.decode_resize_batch_u8(paths, height, width,
                                         num_threads=num_workers), "native"
    from PIL import Image
    out = np.empty((len(paths), height, width, 3), np.uint8)
    for i, p in enumerate(paths):
        img = Image.open(p).convert("RGB").resize(
            (width, height), Image.LANCZOS)
        out[i] = np.asarray(img, np.uint8)
    return out, "pil"


def load_program(prefix: str, device, state: dict | None = None):
    """(the program module with its parameters loaded, the metadata).
    `state` defaults to the bundle <prefix>.params.pt; it is loaded with
    strict=True, so a state dict of another architecture raises."""
    with open(prefix + ".json") as f:
        meta = json.load(f)
    device = torch.device(device)
    exported_on = meta["platforms"][0]
    if device.type != exported_on:
        raise ValueError(
            f"{prefix}.pt2 was exported on {exported_on} "
            f"({meta['platforms'][1]}); it runs there only, not on "
            f"{device.type}: export it again on the serving device")
    if state is None:
        bundle = prefix + ".params.pt"
        if not os.path.exists(bundle):
            raise FileNotFoundError(
                f"{bundle} not found — export with --bundle_params")
        state = torch.load(bundle, map_location=device, weights_only=True)
    program = torch.export.load(prefix + ".pt2").module()
    program.load_state_dict(state, strict=True)
    return program, meta


def main(argv=None, device=None) -> dict:
    """Serves on `device`, else on --device. Returns {"served", "seconds",
    "ms_per_image", "feed"}."""
    from ..utils import device as device_rule

    args = parse_args(argv)
    device = device_rule.resolve_device(device if device is not None
                                        else args.device)
    device_rule.pin_float32(device)
    program, meta = load_program(args.artifact, device)

    b, h, w = meta["batch"], meta["height"], meta["width"]
    u8_in = meta.get("input_dtype") == "uint8"
    paths = _resolve_images(args.images)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    n_done = 0
    feeds = set()
    t0 = time.time()
    for start in range(0, len(paths), b):
        chunk = paths[start:start + b]
        batch, feed = _decode(chunk, h, w, args.num_workers)
        feeds.add(feed)
        if len(chunk) < b:          # static shapes: pad the tail batch
            pad = np.repeat(batch[-1:], b - len(chunk), axis=0)
            batch = np.concatenate([batch, pad], axis=0)
        x = torch.from_numpy(batch).to(device)
        if not u8_in:
            x = x.to(torch.float32) / 255.0
        with torch.inference_mode():
            out = program(x)
        disp = (out[0] if isinstance(out, (tuple, list)) else out)
        disp = disp.cpu().numpy()
        for i, p in enumerate(chunk):
            stem = os.path.splitext(os.path.basename(p))[0]
            dest = (args.out if args.out else os.path.dirname(p)) or "."
            np.save(os.path.join(dest, f"{stem}_disp.npy"),
                    disp[i, :, :, 0])
            n_done += 1
    dt = time.time() - t0
    feed = "+".join(sorted(feeds))
    ms = 1e3 * dt / max(1, n_done)
    print(f"served {n_done} images in {dt:.2f}s "
          f"({ms:.1f} ms/img incl. host decode ({feed} feed); "
          f"model {meta['model']}, {meta['dtype']}, "
          f"input {meta.get('input_dtype', 'float32')}, on {device})")
    return {"served": n_done, "seconds": dt, "ms_per_image": ms,
            "feed": feed}


if __name__ == "__main__":
    main()
