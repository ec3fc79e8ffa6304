"""The work of the training steps of the measured window over the
window's seconds, as a share of the device's float32 peak, in %: 3 x the
dense forward's convs per step (the forward, and a backward of twice its
work), from `benchmark/work/`. The window runs without the profiler."""

from benchmark.work.common import peaks


def read(trace, context):
    steps, seconds = context["window"], context["window_s"]
    if seconds <= 0 or steps <= 0:
        return None
    flops = steps * context["cell"].work.train_step_flops(
        context["batch"], context["height"], context["width"])
    return 100.0 * flops / seconds / peaks()["f32_flops"]
