"""Seeded weights, made on the device in one draw.

The reference of a configuration's family lists its leaves (name, shape,
kind, fan-in); one normal draw from a generator on the device, seeded by
``--seed``, fills them all, each leaf scaled by its kind:

- hidden convolutions: He normal, std sqrt(2 / fan_in), so that a ReLU
  stack keeps the scale of its input;
- output convolutions: std ``out_std / sqrt(fan_in)``, ``out_std`` from
  the configuration's ``init`` (by the leaf's module, default 0.1), so
  that each correction is a few tens of grey levels and the output stays
  inside the uint8 range;
- biases: std 0.02;
- BatchNorm: scale 1 + 0.1 N, shift 0.1 N, running mean 0.1 N, running
  variance exp(0.2 N).

The same dictionary goes to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

BIAS_STD = 0.02


def make(leaves: List[tuple], init: dict, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """Float32 tensors on ``device`` for every leaf, from ``seed``."""
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out_std = init.get("out_std", {})
    out, at = {}, 0
    for name, shape, kind, fan_in in leaves:
        n = math.prod(shape)
        z = draw[at:at + n].view(shape)
        at += n
        if kind == "hidden":
            v = z * math.sqrt(2.0 / fan_in)
        elif kind == "out":
            module = name.rpartition(".")[0]
            v = z * (out_std.get(module, 0.1) / math.sqrt(fan_in))
        elif kind == "bias":
            v = z * BIAS_STD
        elif kind == "bn_weight":
            v = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_mean"):
            v = 0.1 * z
        elif kind == "bn_var":
            v = torch.exp(0.2 * z)
        else:
            raise ValueError(f"unknown leaf kind {kind!r} of {name}")
        out[name] = v
    return out


def program_state(model: torch.nn.Module,
                  weights: Dict[str, torch.Tensor]) -> dict:
    """``model``'s state dict filled from ``weights``: every key must be
    there, save BatchNorm's step counters, which carry no number of the
    model; every weight must be used."""
    state = {}
    for key, value in model.state_dict().items():
        if key in weights:
            if tuple(weights[key].shape) != tuple(value.shape):
                raise ValueError(f"{key}: the reference's shape "
                                 f"{tuple(weights[key].shape)}, the "
                                 f"program's {tuple(value.shape)}")
            state[key] = weights[key]
        elif key.endswith("num_batches_tracked"):
            state[key] = value
        else:
            raise KeyError(f"the reference has no leaf {key}")
    unused = set(weights) - set(state)
    if unused:
        raise KeyError(f"the program has no leaves {sorted(unused)}")
    return state
