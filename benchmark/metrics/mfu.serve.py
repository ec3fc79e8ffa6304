"""The work of the requests served in the measured window (the
configuration's convs, counted from the architecture's shapes and the
benchmark's masks by `benchmark/work/`) over the window's seconds, as a
share of the device's float32 peak (`benchmark/peaks.json`), in %. The
window runs without the profiler, so the host launches at its own pace."""

from benchmark.work.common import peaks


def read(trace, context):
    counts, seconds = context["window"], context["window_s"]
    if seconds <= 0 or not any(counts):
        return None
    work = context["cell"].work
    masks = context["masks"]
    flops = sum(n * work.serve_flops(context["batch"], context["height"],
                                     context["width"],
                                     None if masks is None else masks[b])
                for b, n in enumerate(counts) if n)
    return 100.0 * flops / seconds / peaks()["f32_flops"]
