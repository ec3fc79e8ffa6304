"""One training job: the configuration's train step called back to back.

Set-up builds the step's state once (the benchmark's weights, with the
wavelet heads' 3x3 convs scaled by 0.1 so that no disparity reaches the
clamp), and drives it through its first `first_steps` steps on batches 0,
1, 2 of the pool: those steps are the warm-up, and what they produced is
what `correct` holds against the reference. The same state then runs the
window, cycling through the pool's batches (the loader's layout, made on
the device from the seed) with their automask noise. The host runs at most
one step ahead of the card; the window ends when its last step has
finished, and `train_step_ms` is the window's ms over the steps it
completed.

Parameters (the cell's file): batch, pool, scales, warp (the port's
`stereo_warp_kernel`), first_steps, trace_steps and trace_host_steps (as
the serving driver's trace_requests: run after the window) and limits.

`correct`: after the window the state is freed and the plain reference
(`reference/kitti_train.py`) takes the same first steps from the same
weights, batches and noise. The numbers read (`gaps`) are each step's
relative loss gap and the worst and the median leaf's gap of norms of the
first gradient as Adam got it (from the program's Adam state after step 1)
and of the parameters' change over the first steps, over the leaves whose
reference gradient is at least a thousandth of the median leaf's. Those
that the cell's limits name are compared; the others are printed, marked
as not compared.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from .. import weights as bench_weights
from ..reference import kitti_train
from ..reference.kitti_r18_640x192 import decoder_blocks
from ..reference.common import Precision, precision_mode
from .common import Segment, check, traced


def condition(weights: dict) -> None:
    """Scale the wavelet heads' 3x3 convs by 0.1 (chip_smoke's
    `conditioned_state`)."""
    for idx, (name, _, _) in enumerate(decoder_blocks()):
        if name.endswith(("_pos", "_neg")):
            for leaf in ("weight", "bias"):
                key = f"decoder.{idx}.2.conv.{leaf}"
                weights["decoder"][key] = weights["decoder"][key] * 0.1


class Training:
    def __init__(self, cell, seed: int, device, fault=None):
        p = self.p = cell.params
        self.cell, self.device = cell, device
        self.h, self.w = cell.config["height"], cell.config["width"]
        self.cuda = device.type == "cuda"
        self.batches, self.noises = cell.gen.make_batches(p, self.h, self.w,
                                                          seed, device)
        weights = bench_weights.make(cell.reference.specs(), seed, device)
        condition(weights)
        self.trainer = cell.adapter.Trainer(weights, device, p, cell.config)
        if fault is not None:
            FAULTS[fault](self)
        self.weights = {k: v.cpu() for sd in weights.values()
                        for k, v in sd.items()}
        del weights
        n = int(p["first_steps"])
        self.first_losses = []
        for i in range(n):
            losses = self.step(i)
            self.first_losses.append(float(losses["loss"]))
            if i == 0:
                self.first_grad = {k: v.detach().cpu() for k, v in
                                   self.trainer.first_gradients().items()}
        self.change = {k: v.detach().cpu() - self.weights[k] for k, v in
                       self.trainer.named_parameters().items()}
        self.k = n
        if self.cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

    def step(self, i: int) -> dict:
        b = i % len(self.batches)
        return self.trainer.step(self.batches[b], self.noises[b])

    def window(self, seconds: float, trace: bool, started) -> dict:
        events = []
        setup_s = started()
        t_start = time.perf_counter()
        deadline, steps = t_start + seconds, 0
        while time.perf_counter() < deadline:
            self.step(self.k)
            self.k += 1
            steps += 1
            if self.cuda:
                events.append(torch.cuda.Event())
                events[-1].record()
                if len(events) > 1:
                    events.pop(0).synchronize()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t_start
        res = {"attempted": steps, "failed": 0, "breakdown": None,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                   self.device) if self.cuda else 0),
               "metrics": {"setup_s": setup_s,
                           "train_step_ms": 1e3 * window_s / steps}}
        print(f"window: {steps} steps in {window_s:.3f} s", file=sys.stderr)
        if trace:
            seg = Segment(int(self.p["trace_steps"]),
                          int(self.p["trace_host_steps"]), self.device)
            seg.start()
            for i in range(seg.total):
                self.step(self.k)
                self.k += 1
                seg.unit_done(i + 1)
            traced(self.cell, seg, res, {
                "cell": self.cell, "batch": int(self.p["batch"]),
                "height": self.h, "width": self.w,
                "window": steps, "window_s": window_s})
            del seg
        self.trainer = None
        if self.cuda:
            torch.cuda.empty_cache()
        return res

    def reference(self, precision: str = "f32") -> dict:
        n = len(self.first_losses)
        sd = {k: v.to(self.device) for k, v in self.weights.items()}
        with precision_mode(Precision("tf32" if precision == "tf32"
                                      else "f32")):
            return kitti_train.train(sd, self.batches[:n], self.noises[:n],
                                     n, precision)


def gaps(losses: list, first_grad: dict, change: dict, ref: dict) -> dict:
    """Every number the check can compare: each step's relative loss gap,
    and the worst and the median leaf's gap of norms of the first gradient
    and of the change over the first steps (`kitti_train.leaf_gaps`, over
    the leaves the reference moves; how many it does not move is
    `leaves_left_out`)."""
    keep = kitti_train.moving_leaves(ref["first_grad"])
    dev = next(iter(ref["change"].values())).device
    out = {f"loss_rel.{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(losses, ref["losses"]))}
    out["leaves_left_out"] = len(ref["first_grad"]) - len(keep)
    for name, prog, key in (("grad_norm_gap", first_grad, "first_grad"),
                            ("change_norm_gap", change, "change")):
        g = kitti_train.leaf_gaps(
            {k: v.to(dev).to(ref[key][k].dtype) for k, v in prog.items()},
            ref[key], keep)
        out[name] = max(g.values())
        out[f"{name}.median"] = statistics.median(g.values())
        out[f"{name}.worst_leaf"] = max(g, key=g.get)
    return out


def _half_batch(t: Training) -> None:
    """Each step computes over the first half of its batch's rows, its
    means taken over them."""
    step = t.trainer.step

    def half(batch, noise):
        n = next(iter(batch.values())).shape[0] // 2
        return step({k: v[:n] for k, v in batch.items()},
                    {k: v[:n] for k, v in noise.items()})
    t.trainer.step = half


def _unchanged(t: Training) -> None:
    """The optimizer's step returns the state unchanged."""
    t.trainer.state.optimizer.step = lambda *a, **k: None


FAULTS = {"half_batch": _half_batch, "unchanged": _unchanged}


def run(cell, seed: int, seconds: float, trace: bool, device, started,
        fault=None) -> dict:
    """One run of the training cell; `fault` (a name in FAULTS: tests and
    calibration only) breaks the timed path underneath."""
    t = Training(cell, seed, device, fault)
    res = t.window(seconds, trace, started)
    ref = t.reference()
    limits = cell.params["limits"]
    read = gaps(t.first_losses, t.first_grad, t.change, ref)
    res["checks"] = {k: check(v, limits[k]) for k, v in read.items()
                     if k in limits}
    print("not compared (no limit in the cell's file): " + ", ".join(
        f"{k} {v!r}" for k, v in read.items() if k not in limits),
        file=sys.stderr)
    res["correct"] = bool(res["attempted"] > 0 and all(
        c["ok"] for c in res["checks"].values()))
    return res


def calibrate(cell, seed: int, seconds: float, device, fault=None) -> dict:
    """The compared numbers of one seed: the program (or the program with
    `fault` planted), and without a fault also the control (the
    reference in TF32) and the float32 reference itself, each against the
    float32 reference (float64 for the last: float32's own rounding)."""
    t0 = time.perf_counter()
    t = Training(cell, seed, device, fault)
    t.window(seconds, False, lambda: time.perf_counter() - t0)
    ref = t.reference()
    if fault is not None:
        return {"program": gaps(t.first_losses, t.first_grad, t.change,
                                ref)}
    ctl = t.reference("tf32")
    f64 = t.reference("f64")
    return {"program": gaps(t.first_losses, t.first_grad, t.change, ref),
            "control": gaps(ctl["losses"], ctl["first_grad"],
                            ctl["change"], ref),
            "f32_vs_f64": gaps(ref["losses"], ref["first_grad"],
                               ref["change"], f64)}
