"""Seeded weights made by the benchmark on the device, in one draw.

A configuration's reference lists its state dicts as [(key, shape, kind)].
`make` draws one flat U(-1, 1) buffer for all of them from a
`torch.Generator` on the device and scales each leaf by its kind: convs
take the fan-in init (weights U(+-sqrt(3 / fan_in)), biases U(+-1 /
sqrt(fan_in))), BatchNorm a scale of 1 +- 0.1, a shift of +-0.1, a running
mean of +-0.1 and a running variance of 1 +- 0.1, so that eval-mode BN is
not the identity. The same tensors go to the program (`load_state_dict(...,
strict=True)`) and to the reference.
"""

from __future__ import annotations

import math

import torch


BN = {"bn_weight": (0.1, 1.0), "bn_bias": (0.1, 0.0), "bn_mean": (0.1, 0.0),
      "bn_var": (0.1, 1.0)}       # (multiplier, offset) of the U(-1, 1) draw


def make(specs: dict, seed: int, device) -> dict:
    """{module: {key: tensor}} for {module: [(key, shape, kind)]}."""
    leaves = [(m, k, tuple(s), kind) for m, spec in specs.items()
              for k, s, kind in spec if kind != "count"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(sum(math.prod(s) for _, _, s, _ in leaves),
                       device=device).uniform_(-1.0, 1.0, generator=gen)
    out = {m: {} for m in specs}
    pos, fan_in = 0, {}
    for m, k, s, kind in leaves:
        t = flat[pos:pos + math.prod(s)].view(s)
        pos += math.prod(s)
        layer = k.rsplit(".", 1)[0]
        if kind == "conv_weight":
            fan_in[layer] = math.prod(s[1:])
            out[m][k] = t * math.sqrt(3.0 / fan_in[layer])
        elif kind == "conv_bias":          # after its weight in every spec
            out[m][k] = t * fan_in[layer] ** -0.5
        else:
            mul, off = BN[kind]
            out[m][k] = t * mul + off
    for m, spec in specs.items():
        for k, s, kind in spec:
            if kind == "count":
                out[m][k] = torch.zeros(s, dtype=torch.long, device=device)
        out[m] = {k: out[m][k] for k, _, _ in spec}
    return out
