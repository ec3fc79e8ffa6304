"""Share of the traced serving window in which no device event ran:
1 - (union of the device events' intervals) / window, in %."""


def read(trace, context):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us() / 1e6 / trace.window_s)
