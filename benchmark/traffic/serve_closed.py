"""Closed-loop serving: one client, one request in flight.

Each request takes the next batch of the pool in turn (pinned host memory),
copies it to the card, scales it to [0, 1] there, runs the configuration's
adapter (encoder, then decoder: dense, or sparse under the pool's masks)
and copies the scale-0 disparity into pinned host memory; it ends when
that copy has finished. Nothing else synchronises, so a request's kernels
are queued ahead of the card. Latency runs from the request's start on
the host to its output in host memory.

Parameters (the cell's file): batch, pool (a multiple of batch), mask_rule
and density (sparse cells; see `gen/serve_pool.py`), backend (the sparse
decoder's `use_pallas`), warmup (passes over the pool before the window),
sample (requests of the window kept for the check, a reservoir sample
drawn from the seed), trace_requests and trace_host_requests (requests
that a --trace 1 run serves once the window has closed, traced on the
device alone, then with the host's ops and spans), scene_seed
(`gen/serve_pool.py`), tile_kernel (the device name of the tile-sparse
conv kernel) and limits.

`correct`: once the window has closed and the program's state is freed,
the plain reference recomputes each sampled request from the same frames,
masks and weights, and the disparities (and, sparse, the dilated masks and
`total_ops`) are compared with what the window served.
"""

from __future__ import annotations

import random
import sys
import time

import torch

from .. import weights as bench_weights
from ..reference.common import Precision, precision_mode
from .common import Segment, check, quantile, traced


def _host_like(t: torch.Tensor, pin: bool) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)


class Buffers:
    """Host buffers (pinned on the card's host) for one request's
    outputs: the disparity, and in `full` ones the masks and op counts."""

    def __init__(self, out: dict, full: bool, pin: bool):
        self.disp = _host_like(out["disp"], pin)
        self.masks = self.ops = None
        if full and "masks" in out:
            self.masks = {k: _host_like(v, pin)
                          for k, v in out["masks"].items()}
            self.ops = _host_like(out["total_ops"], pin)

    def fill(self, out: dict) -> None:
        self.disp.copy_(out["disp"], non_blocking=True)
        if self.masks is not None:
            for k, v in out["masks"].items():
                self.masks[k].copy_(v, non_blocking=True)
            self.ops.copy_(out["total_ops"], non_blocking=True)

    def outputs(self) -> dict:
        out = {"disp": self.disp}
        if self.masks is not None:
            out["masks"], out["total_ops"] = self.masks, self.ops
        return out


class Serving:
    """Set-up of a serving cell: the pool, the weights, the program's
    server, the pinned inputs, the masks on the device and the output
    buffers; every request shape warmed up."""

    def __init__(self, cell, seed: int, device, fault=None):
        p = self.p = cell.params
        self.cell, self.seed, self.device = cell, seed, device
        self.h, self.w = cell.config["height"], cell.config["width"]
        self.batch = int(p["batch"])
        self.nb = int(p["pool"]) // self.batch
        self.cuda = device.type == "cuda"
        pool = cell.gen.make_pool(p, self.h, self.w, seed, device)
        self.raw = pool.masks
        if self.raw is not None:
            print(f"masks: rule {p['mask_rule']}, ratio {pool.ratio!r}, "
                  f"density {pool.density!r} (target {p['density']})",
                  file=sys.stderr, flush=True)
        weights = bench_weights.make(cell.reference.specs(), seed, device)
        self.server = cell.adapter.Server(weights, device, p)
        self.server.ratio = pool.ratio
        self.host_weights = {k: v.cpu() for sd in weights.values()
                             for k, v in sd.items()}
        del weights
        frames = pool.frames.cpu()
        del pool
        if self.cuda:
            frames = frames.pin_memory()
        self.inputs = [frames[b * self.batch:(b + 1) * self.batch]
                       for b in range(self.nb)]
        self.masks = [self.raw_masks(b, device) for b in range(self.nb)]
        if fault is not None:
            FAULTS[fault](self)
        out = self.serve(0)
        self.common = Buffers(out, False, self.cuda)
        self.slots = [Buffers(out, True, self.cuda)
                      for _ in range(int(p["sample"]))]
        del out
        for _ in range(int(p["warmup"])):
            for b in range(self.nb):
                self.common.fill(self.serve(b))
        if self.cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

    def raw_masks(self, b: int, device) -> dict | None:
        if self.raw is None:
            return None
        lo, hi = b * self.batch, (b + 1) * self.batch
        return {s: torch.from_numpy(m[lo:hi]).to(device)
                for s, m in self.raw.items()}

    def serve(self, b: int) -> dict:
        x = self.inputs[b].to(self.device, non_blocking=True).float() / 255.0
        return self.server(x, self.masks[b])

    def window(self, seconds: float, trace: bool, started) -> dict:
        """The measured window, then (trace runs) the traced requests;
        then the program is freed. Returns the end-to-end metrics, the
        traced segment's readings and the kept requests."""
        rng = random.Random(self.seed)
        self.kept = [None] * len(self.slots)   # (request, batch) per slot
        done = torch.cuda.Event() if self.cuda else None

        def request(k: int, dst: Buffers) -> None:
            dst.fill(self.serve(k % self.nb))
            if done is not None:
                done.record()
                done.synchronize()

        lat = []
        setup_s = started()
        t_start = time.perf_counter()
        deadline, t_end, k = t_start + seconds, t_start, 0
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline:
                break
            j = k if k < len(self.slots) else rng.randrange(k + 1)
            dst = self.common
            if j < len(self.slots):
                dst, self.kept[j] = self.slots[j], (k, k % self.nb)
            request(k, dst)
            t_end = time.perf_counter()
            lat.append(t_end - t0)
            k += 1
        window_s = t_end - t_start
        res = {"attempted": k, "failed": 0, "breakdown": None,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                   self.device) if self.cuda else 0),
               "metrics": {"setup_s": setup_s,
                           "infer_fps": k * self.batch / window_s,
                           "infer_p95_ms": 1e3 * quantile(lat, 0.95)}}
        print(f"window: {k} requests in {window_s:.3f} s, latency p50 "
              f"{1e3 * quantile(lat, 0.5):.3f} ms", file=sys.stderr)
        if trace:
            seg = Segment(int(self.p["trace_requests"]),
                          int(self.p["trace_host_requests"]), self.device,
                          ("encoder", "decoder"))
            seg.start()
            for i in range(seg.total):
                request(k + i, self.common)
                seg.unit_done(i + 1)
            raw = [None if self.raw is None else
                   {s: m[b * self.batch:(b + 1) * self.batch]
                    for s, m in self.raw.items()} for b in range(self.nb)]
            window = [0] * self.nb
            for i in range(k):
                window[i % self.nb] += 1
            traced(self.cell, seg, res, {
                "cell": self.cell, "batch": self.batch, "height": self.h,
                "width": self.w,
                "masks": None if self.raw is None else raw,
                "traced": [(k + i) % self.nb
                           for i in range(seg.units[0])],
                "window": window, "window_s": window_s})
            del seg
        self.free()
        return res

    def free(self) -> None:
        self.server = self.masks = None
        if self.cuda:
            torch.cuda.empty_cache()

    def served(self) -> list:
        """[(pool batch, outputs)] of the kept requests."""
        return [(kb[1], s.outputs()) for kb, s in zip(self.kept, self.slots)
                if kb is not None]

    def reference(self, b: int, precision: str = "f32") -> dict:
        sd = {k: v.to(self.device) for k, v in self.host_weights.items()}
        p = Precision(precision)
        with torch.no_grad(), precision_mode(p):
            return self.cell.reference.serve(
                self.inputs[b].to(self.device), sd, p,
                self.raw_masks(b, self.device))


def gaps(served: list, reference) -> dict:
    """The compared numbers of served outputs against `reference(b)`:
    disp_max_abs, and for sparse outputs mask_mismatch (elements of the
    dilated masks that differ, all of a missing mask) and total_ops_rel
    (the largest relative gap of an image's op count)."""
    disp_gap = ops_gap = 0.0
    mismatch = 0
    sparse = False
    for b, out in served:
        ref = reference(b)
        dev = ref["disp"].device
        disp_gap = max(disp_gap, float((out["disp"].to(dev).float()
                                        - ref["disp"]).abs().max()))
        if "masks" in ref:
            sparse = True
            got = out.get("masks", {})
            for key, m in ref["masks"].items():
                mismatch += (int(m.numel()) if key not in got else
                             int((got[key].to(dev) != m).sum()))
            mismatch += len(set(got) - set(ref["masks"]))
            ops = out["total_ops"].to(dev).double()
            ops_gap = max(ops_gap, float(((ops - ref["total_ops"]).abs()
                                          / ref["total_ops"]).max()))
    out = {"disp_max_abs": disp_gap}
    if sparse:
        out["mask_mismatch"] = float(mismatch)
        out["total_ops_rel"] = ops_gap
    return out


def _answer_altered(s: Serving) -> None:
    """One served disparity per request moved by 0.01 where the program
    produced it."""
    server = s.server

    def altered(x, masks):
        out = dict(server(x, masks))
        out["disp"] = out["disp"].clone()
        out["disp"][0, 0, 0, 0] += 0.01
        return out
    s.server = altered


def _half_batch(s: Serving) -> None:
    """The program computes the first half of each batch; the other half's
    outputs stay zero."""
    server = s.server

    def half(x, masks):
        n = x.shape[0] // 2
        out = dict(server(x[:n], None if masks is None else
                          {k: m[:n] for k, m in masks.items()}))

        def pad(t):
            return torch.cat([t, torch.zeros((x.shape[0] - n,) + t.shape[1:],
                                             dtype=t.dtype,
                                             device=t.device)])
        out["disp"] = pad(out["disp"])
        if "masks" in out:
            out["masks"] = {k: pad(v) for k, v in out["masks"].items()}
            out["total_ops"] = pad(out["total_ops"])
        return out
    s.server = half


def _mask_pixel(s: Serving) -> None:
    """One pixel of each image's raw mask at the finest sparse scale
    flipped in what the program is given (the reference keeps the true
    masks)."""
    if s.raw is None:
        return
    scale = min(s.raw)
    for m in s.masks:
        m[scale] = m[scale].clone()
        m[scale][:, 0, 0, 0] = 1.0 - m[scale][:, 0, 0, 0]


FAULTS = {"answer_altered": _answer_altered, "half_batch": _half_batch,
          "mask_pixel": _mask_pixel}


def calibrate(cell, seed: int, seconds: float, device, fault=None) -> dict:
    """The compared numbers of one seed after a short window: the program
    (or the program with `fault` planted) and the control, each against
    the float32 reference."""
    t0 = time.perf_counter()
    s = Serving(cell, seed, device, fault)
    s.window(seconds, False, lambda: time.perf_counter() - t0)
    served = s.served()
    out = {"program": gaps(served, s.reference)}
    if fault is None:
        out["control"] = gaps([(b, s.reference(b, "tf32"))
                               for b, _ in served], s.reference)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, started,
        fault=None) -> dict:
    """One run of a serving cell; `fault` (a name in FAULTS: tests and
    calibration only) breaks the timed path underneath."""
    s = Serving(cell, seed, device, fault)
    res = s.window(seconds, trace, started)
    served = s.served()
    limits = cell.params["limits"]
    res["checks"] = {k: check(v, limits[k])
                     for k, v in gaps(served, s.reference).items()}
    res["correct"] = bool(served and res["attempted"] > 0 and all(
        c["ok"] for c in res["checks"].values()))
    return res
