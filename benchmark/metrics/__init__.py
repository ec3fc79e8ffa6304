"""Per-layer metric readers, one file per metric, named as the metric.

Each defines `read(trace, context) -> float | None`: `trace` is the traced
segment (`benchmark.trace.Trace`), `context` what the traffic driver knows
of it (the cell, batch, frame size, the masks of each pool batch, which
batch each traced request served, or the steps traced). A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""
