"""Device ms per request of the events launched inside the benchmark's
`record_function("encoder")` span around the encoder call (the host part of
the trace, which records the spans)."""


def read(trace, context):
    host = context["host_trace"]
    if not host.units or not host.device:
        return None
    us = host.span_us("encoder")
    return us / 1e3 / host.units if us > 0 else None
