"""Shared pieces of the drivers: the traced segment, the checks, the
quantiles."""

from __future__ import annotations

import sys
import time


def quantile(values: list, q: float) -> float:
    """The q-quantile of all values, linearly interpolated between order
    statistics (numpy's default)."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Segment:
    """The profiler over units run after the measured window (trace runs
    only), in two parts: `device_units` requests or steps with the CUDA
    activity alone (the device's busy time, idle share and kernels, at the
    least cost to the host), then `host_units` more with the CPU activity
    too (the host spans and ops that each device event is attributed to).
    `unit_done(k)` after the k-th unit has been issued; each part ends
    when its last unit has finished on the device. The window itself runs
    without the profiler, which slows the host while it records and, on
    some machines, after it has closed."""

    def __init__(self, device_units: int, host_units: int, device,
                 spans=()):
        self.device = device
        self.units = (device_units, host_units)
        self.spans = tuple(spans)
        self.profs, self.windows = [], []
        self.t0 = 0.0

    @property
    def total(self) -> int:
        return sum(self.units)

    def _open(self, activities) -> None:
        import torch
        from torch.profiler import profile
        torch.cuda.synchronize(self.device)
        self.profs.append(profile(activities=activities))
        self.profs[-1].__enter__()
        self.t0 = time.perf_counter()

    def _close(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)
        self.windows.append(time.perf_counter() - self.t0)
        self.profs[-1].__exit__(None, None, None)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity
        self._open([ProfilerActivity.CUDA])

    def unit_done(self, k: int) -> None:
        if k == self.units[0]:
            from torch.profiler import ProfilerActivity
            self._close()
            self._open([ProfilerActivity.CPU, ProfilerActivity.CUDA])
        elif k == self.total:
            self._close()

    def read(self):
        """(device trace, host trace)."""
        from ..trace import Trace
        dev = Trace.from_profile(self.profs[0], (), self.windows[0],
                                 self.units[0])
        host = Trace.from_profile(self.profs[1], self.spans,
                                  self.windows[1], self.units[1])
        print(f"trace: {len(dev.device)} device events in "
              f"{dev.window_s:.4f} s over {dev.units} units; host part "
              f"{len(host.device)} events in {host.window_s:.4f} s, "
              f"{host.unlinked} without their launch", file=sys.stderr)
        return dev, host


def check(value: float, limit: float) -> dict:
    return {"value": value, "limit": limit, "ok": bool(value <= limit)}


def traced(cell, seg: Segment, res: dict, context: dict) -> None:
    """Fill `res` from the traced parts: busy_s and window_s of the device
    part, the breakdown (device ops of the device part, idle gaps named by
    the host part's ops) and every per-layer metric that its reader
    finds."""
    dev, host = seg.read()
    res["busy_s"] = dev.busy_us() / 1e6
    res["window_s"] = dev.window_s
    res["breakdown"] = {"device_ops": dev.breakdown()["device_ops"],
                        "idle_gaps": host.breakdown()["idle_gaps"]}
    context = dict(context, host_trace=host)
    res["metrics"].update(per_layer(cell, dev, context))


def per_layer(cell, trace, context: dict) -> dict:
    """Every per-layer metric of the cell that its reader finds: `trace`
    is the device part, `context["host_trace"]` the host part."""
    out = {}
    for name, reader in cell.readers.items():
        v = reader.read(trace, context)
        if v is not None:
            out[name] = v
    return out

