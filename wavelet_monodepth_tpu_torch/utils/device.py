"""The device rule of the port's entry points: they run on the card
unless the caller asks for the CPU, and raise when no card is visible;
and they run float32 as float32 on it (`pin_float32`)."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), after checking that a CUDA device exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA card is visible (torch.cuda."
            "is_available() is False); pass --device cpu to run on the CPU")
    return dev


def pin_float32(device) -> None:
    """float32 means float32 on the card: with a CUDA `device`, turn TF32
    off for cuBLAS matmuls and cuDNN convolutions (cuDNN's flag defaults
    to on). Every CLI calls it; a CPU device leaves the flags alone."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
