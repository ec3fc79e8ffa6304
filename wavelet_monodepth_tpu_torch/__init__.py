"""PyTorch + CUDA port of `wavelet_monodepth_tpu` for NVIDIA Hopper.

The package mirrors the JAX package's module layout (`ops/`, `models/`,
`utils/`, `tools/`) so each module's counterpart is found by name. It
imports torch and numpy and never JAX or anything of
`wavelet_monodepth_tpu`; the JAX package stays the reference the port is
tested against (`tests/test_torch_port_*.py`).

Conventions:
  * public functions and the decoder's output dict are NHWC with the JAX
    package's tuple keys;
  * weights keep torch's OIHW layout and the reference's state-dict names;
  * dense convs, BN, pooling and elementwise ops go to cuDNN/ATen; the
    tile-sparse 3x3 conv that the JAX package wrote in Pallas is a CUDA
    C++ kernel (`csrc/tile_sparse_conv.cu`, built by `kernels/build.py`).
"""
