"""Plain float32 reference of the U-Net family's interpolator: two gray or
colour frames in, the midpoint out; more in-betweens by bisection.

Edge pad to the pad multiple, space-to-depth by ``r`` (channels in (dy,
dx, c) order), the U-Net core over both frames' channels, the residual
midpoint ``+ (f1 + f2) / 2`` in the space-to-depth layout, depth-to-space,
then the full-resolution refinement head over (prediction, f1, f2), crop,
round to uint8. BatchNorm is applied from its statistics, not folded.
"""

from __future__ import annotations

import math
from typing import List

import torch

from . import nets


def _check(model: dict) -> None:
    unsupported = {"arch": "unet", "bilinear": True, "time_conditioned": False,
                   "refine_depthwise": False, "refine_factor": 1}
    for key, want in unsupported.items():
        if model[key] != want:
            raise ValueError(
                f"the U-Net reference has no {key}={model[key]!r}")


def leaves(model: dict) -> List[nets.Leaf]:
    """Every parameter and BatchNorm statistic of the unfolded model."""
    _check(model)
    r, c = model["space_to_depth"], model["channels"]
    out = nets.unet_leaves("unet", 2 * c * r * r, c * r * r,
                           model["base_width"], model["depth"])
    if model["refine_width"] > 0 and r > 1:
        out += nets.head_leaves(3 * c, model["refine_width"], c)
    return out


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // r, r, w // r, r)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    b, cr, h, w = x.shape
    c = cr // (r * r)
    x = x.reshape(b, r, r, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c, h * r, w * r)


def predict(p: nets.Params, x1: torch.Tensor, x2: torch.Tensor, model: dict,
            q: nets.Quant = None) -> torch.Tensor:
    """The midpoint of padded float32 NCHW frames in [-1, 1], float32."""
    r = model["space_to_depth"]
    s1, s2 = space_to_depth(x1, r), space_to_depth(x2, r)
    y = nets.unet(torch.cat([s1, s2], 1), p, "unet", model["depth"],
                  model["upsample"], q)
    if model["residual"]:
        y = y + 0.5 * (s1 + s2)
    y = depth_to_space(y, r)
    if model["refine_width"] > 0 and r > 1:
        y = y + nets.head(torch.cat([y, x1, x2], 1), p, q)
    return y


def _bisect(p, x1, x2, model, depth, q):
    """The 2**depth - 1 dyadic in-betweens of padded frames, in time order,
    each level computed from the unrounded level above."""
    if depth == 0:
        return []
    mid = predict(p, x1, x2, model, q)
    return (_bisect(p, x1, mid, model, depth - 1, q) + [mid] +
            _bisect(p, mid, x2, model, depth - 1, q))


@torch.no_grad()
def inbetweens(p: nets.Params, f1_u8: torch.Tensor, f2_u8: torch.Tensor,
               model: dict, n: int = 1, q: nets.Quant = None) -> torch.Tensor:
    """uint8 [B,H,W,C] pairs -> uint8 [B,n,H,W,C]: the dyadic in-betweens
    at the times nearest i/(n+1), by bisection to the least depth that
    holds ``n`` (exact where n+1 is a power of two)."""
    _check(model)
    h, w = f1_u8.shape[1:3]
    m = nets.pad_multiple(model)
    x1 = nets.pad_edge(nets.normalize(f1_u8), m)
    x2 = nets.pad_edge(nets.normalize(f2_u8), m)
    depth = max(1, math.ceil(math.log2(n + 1)))
    total = 2 ** depth - 1
    idx = [min(total - 1, round((i + 1) * (total + 1) / (n + 1)) - 1)
           for i in range(n)]
    with nets.no_tf32():
        mids = _bisect(p, x1, x2, model, depth, q)
        return torch.stack([nets.to_uint8(mids[i][..., :h, :w])
                            for i in idx], 1)
