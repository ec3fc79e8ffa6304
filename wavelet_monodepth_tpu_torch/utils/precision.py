"""bfloat16 inference: a full cast of the model, its input and outputs.

Counterpart of `wavelet_monodepth_tpu/utils/precision.py`. `--bfloat16`
on the inference CLI runs the whole encoder and decoder in bfloat16:
every float parameter and every float buffer (the BN running statistics
too, as JAX casts its `batch_stats`) becomes bfloat16, the input image
is cast to bfloat16, and every float output comes back as float32.
Integer buffers (`num_batches_tracked`) keep their dtype. This is not
`torch.autocast`, which keeps some ops in float32: the port follows JAX.
"""

from __future__ import annotations

from typing import Any

import torch


def cast_floats(obj: Any, dtype: torch.dtype) -> Any:
    """Cast every floating-point tensor of `obj` to `dtype`. `obj` is a
    module (its parameters and buffers, in place; returned), a tensor, or
    a dict / list / tuple of them (a state dict, an output dict), rebuilt
    with the same keys; anything else is returned as it is."""
    if isinstance(obj, torch.nn.Module):
        return obj.to(dtype)        # float parameters and buffers only
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return type(obj)((k, cast_floats(v, dtype)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast_floats(v, dtype) for v in obj)
    return obj


def wrap_forward_bf16(forward):
    """Wrap forward(image, ...) whose modules are already bfloat16 so that
    the image is cast to bfloat16 and every float output comes back as
    float32. A uint8 image passes as it is (the model scales it)."""
    def wrapped(image: torch.Tensor, *args, **kwargs):
        if image.dtype != torch.uint8:
            image = image.to(torch.bfloat16)
        return cast_floats(forward(image, *args, **kwargs), torch.float32)
    return wrapped
