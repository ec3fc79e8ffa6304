"""Shared arithmetic of the work counts.

A convolution's work is 2 * (Cin / groups) * k * k * Cout operations per
output pixel (a multiply and an add per weight); biases, activations,
pooling, concatenation and the wavelet synthesis are not counted. Bytes
are float32: a tile-sparse conv reads each active output pixel's input
vector once (a lower bound: the 3x3 neighbourhoods it also needs are not
counted), its mask once and its weights once, and writes its whole output
once.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..reference.common import stage_masks

F32 = 4


def conv_flops(cin: int, cout: int, k: int, pixels: float,
               groups: int = 1) -> float:
    return 2.0 * (cin // groups) * k * k * cout * pixels


def sparse_conv_bytes(cin: int, cout: int, active: float, pixels: float
                      ) -> float:
    """Bytes of one tile-sparse 3x3 conv over `pixels` output pixels of
    which `active` are computed."""
    return F32 * (active * cin + pixels + 9 * cin * cout + cout
                  + pixels * cout)


def peaks() -> dict:
    return json.loads((Path(__file__).resolve().parent.parent
                       / "peaks.json").read_text())


def active_pixels(raw) -> dict:
    """Active pixels of each dilated mask (the published rule,
    `reference.common.stage_masks`) over a batch of raw (N, h, w, 1)
    masks."""
    m = torch.as_tensor(raw, dtype=torch.float32).permute(0, 3, 1, 2)
    return {k: float(v.sum()) for k, v in stage_masks(m).items()}
