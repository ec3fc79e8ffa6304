"""Share of the traced steps' device time in events launched by
convolution ops, forward and backward (their innermost ATen op's name
holds "conv": cudnn_convolution, convolution_backward, ...), in % (the
host part of the trace, which records the ops)."""


def read(trace, context):
    host = context["host_trace"]
    total = host.device_us()
    if total <= 0:
        return None
    return 100.0 * host.by_op_us(lambda op: "conv" in op) / total
