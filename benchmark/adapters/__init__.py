"""The benchmark's calls into the port, one module per configuration.

Each builds the port's modules through its normal entry points, loads the
benchmark's weights with `strict=True`, and wraps the encoder and decoder
calls in the benchmark's own `record_function` spans ("encoder",
"decoder"), which the per-layer readers attribute device time to.
"""
