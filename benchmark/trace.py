"""The profiler's trace of a traced segment, read once for every per-layer
metric.

Read from the kineto results of `torch.profiler.profile` (CPU + CUDA
activities), as chip_smoke.py's `Trace` reads them, without building a
FunctionEvent per event. On the card each device event (kernel, memcpy,
memset) carries the CUPTI correlation id of the runtime call that launched
it (`cudaLaunchKernel`, `cudaMemcpyAsync`, ... on the host, the same id)
and, as its linked id, the correlation id of the innermost ATen op that
was running then (none for a launch outside every op). So every device
event is tied to its launch time and thread on the host, and to the op
that launched it; a host span (a `record_function` of the benchmark's own)
owns the device events launched inside it on its thread. GPU user
annotations (the device-side copies of those spans) are no device work and
are left out.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


def _api_call(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    ...), which shares its correlation id with the device event it
    launched. Kernels launched outside any ATen op (the port's ctypes
    launches) have such a call but no linked op."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


@dataclass
class DeviceEvent:
    name: str
    start: float            # us since the trace's start
    end: float
    launch: tuple | None    # (host thread, launch time in us) or None
    op: str | None          # the innermost host op that launched it

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """device: every device event; spans: {name: {thread: [(start, end)]}}
    of the host spans asked for; window_s: the traced part's host seconds;
    units: the requests or steps traced; unlinked: device events whose
    launch the trace lacks (in no span)."""
    device: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    window_s: float = 0.0
    units: int = 0
    unlinked: int = 0

    @classmethod
    def from_profile(cls, prof, span_names=(), window_s: float = 0.0,
                     units: int = 0) -> "Trace":
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        res = prof.profiler.kineto_results
        t0 = res.trace_start_ns()
        runtime, ops, raw_device = {}, {}, []
        spans = {n: {} for n in span_names}
        for ev in res.events():
            name = ev.name()
            start = (ev.start_ns() - t0) / 1e3
            end = (ev.end_ns() - t0) / 1e3
            if ev.device_type() == cuda:
                if not (getattr(ev, "is_user_annotation", lambda: False)()
                        or name in spans):
                    raw_device.append((name, start, end, ev.correlation_id(),
                                       ev.linked_correlation_id()))
                continue
            thread = ev.start_thread_id()
            if _api_call(name):
                runtime[ev.correlation_id()] = (thread, start)
            elif name in spans:
                spans[name].setdefault(thread, []).append((start, end))
            elif "::" in name:          # ATen and autograd ops
                ops[ev.correlation_id()] = name
        trace = cls(spans=spans, window_s=window_s, units=units)
        for name, start, end, corr, linked in raw_device:
            launch = runtime.get(corr)
            trace.unlinked += launch is None
            trace.device.append(DeviceEvent(name, start, end, launch,
                                            ops.get(linked)))
        trace.device.sort(key=lambda d: (d.start, -d.end))
        for by_thread in spans.values():
            for intervals in by_thread.values():
                intervals.sort()
        return trace

    def busy_us(self) -> float:
        """The union of the device events' intervals."""
        busy, cur_s, cur_e = 0.0, None, None
        for d in self.device:
            if cur_e is None or d.start > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = d.start, d.end
            else:
                cur_e = max(cur_e, d.end)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def device_us(self) -> float:
        """Summed device time (overlaps counted twice; one stream here)."""
        return sum(d.duration for d in self.device)

    def in_span(self, d: DeviceEvent, name: str) -> bool:
        """Whether `d` was launched inside host span `name`."""
        if d.launch is None:
            return False
        intervals = self.spans.get(name, {}).get(d.launch[0], [])
        i = bisect.bisect_right(intervals, (d.launch[1], float("inf"))) - 1
        return i >= 0 and intervals[i][0] <= d.launch[1] <= intervals[i][1]

    def span_us(self, name: str) -> float:
        return sum(d.duration for d in self.device if self.in_span(d, name))

    def kernels_us(self, substring: str) -> float:
        return sum(d.duration for d in self.device if substring in d.name)

    def by_op_us(self, predicate) -> float:
        """Device time of the events whose launching op satisfies
        `predicate(op name)`."""
        return sum(d.duration for d in self.device
                   if d.op is not None and predicate(d.op))

    def breakdown(self, top: int = 10) -> dict:
        """The device events that took most time, and the idle gaps between
        device events summed by the host op that launched the event after
        each gap, both in seconds."""
        by_name, gaps = {}, {}
        last_end = None
        for d in self.device:
            by_name[d.name] = by_name.get(d.name, 0.0) + d.duration
            if last_end is not None and d.start > last_end:
                who = d.op or "(no host op)"
                gaps[who] = gaps.get(who, 0.0) + (d.start - last_end)
            last_end = d.end if last_end is None else max(last_end, d.end)

        def rank(m):
            return sorted(m.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v / 1e6] for n, v in rank(by_name)],
                "idle_gaps": [[n, v / 1e6] for n, v in rank(gaps)]}
