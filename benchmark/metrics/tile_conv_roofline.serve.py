"""The tile-sparse conv kernel's share of its roofline in the traced
requests: the least time the device could take for the sparse scales'
3x3 convs (operations at the float32 peak or bytes at the memory
bandwidth, whichever is longer; `benchmark/work/`) over the device time
of the kernels that the cell's `tile_kernel` parameter names, in %."""

from benchmark.work.common import peaks


def read(trace, context):
    masks = context["masks"]
    name = context["cell"].params.get("tile_kernel")
    if masks is None or not name:
        return None
    kernel_us = trace.kernels_us(name)
    if kernel_us <= 0:
        return None
    flops = nbytes = 0.0
    for b in context["traced"]:
        w = context["cell"].work.tile_conv_work(context["height"],
                                                context["width"], masks[b])
        flops += w["flops"]
        nbytes += w["bytes"]
    pk = peaks()
    least_s = max(flops / pk["f32_flops"], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * least_s / (kernel_us / 1e6)
