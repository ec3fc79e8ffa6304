"""Plain PyTorch references of the benchmark's configurations.

They import neither JAX, nor the JAX package, nor anything of the port:
each is a straightforward NCHW float32 implementation of the published
architecture (and, for training, of its loss and optimizer step), with no
kernel, cache or batching of the program. They read the weights and inputs
that the benchmark made, never what the program derived from them.
"""
