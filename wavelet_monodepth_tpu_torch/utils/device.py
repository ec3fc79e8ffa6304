"""The device rule of the port's entry points: they run on the card
unless the caller asks for the CPU, and raise when no card is visible."""

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
