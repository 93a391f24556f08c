"""Plain float32 reference of the flow family's interpolator (one motion
field, the shifts warp): two frames in, the frame at time t out.

Edge pad to the pad multiple; the motion U-Net over both frames, average
pooled by ``flow_scale``, predicts a field (x, y in pixels) and a blend
logit, which are resized back on the half-pixel grid, the field scaled by
``flow_scale``; each frame is warped toward time t (``-t F`` and ``(1-t)
F``, each axis bounded by ``max_flow``), blended by ``(1-t) m`` and ``t
(1-m)`` with ``m = sigmoid(logit)``, and corrected by the refinement head
over (blend, both warps, both frames); crop, round to uint8.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from . import nets


def _check(model: dict) -> None:
    unsupported = {"arch": "flow", "bilinear": True, "space_to_depth": 1,
                   "flow_bidir": False, "flow_cascade": 0,
                   "warp_impl": "shifts"}
    for key, want in unsupported.items():
        if model[key] != want:
            raise ValueError(f"the flow reference has no {key}={model[key]!r}")


def leaves(model: dict) -> List[nets.Leaf]:
    _check(model)
    c = model["channels"]
    out = nets.unet_leaves("motion_unet", 2 * c, 3, model["base_width"],
                           model["depth"])
    if model["refine_width"] > 0:
        out += nets.head_leaves(5 * c, model["refine_width"], c)
    return out


def predict(p: nets.Params, x1: torch.Tensor, x2: torch.Tensor, t: float,
            model: dict, q: nets.Quant = None) -> torch.Tensor:
    """The frame at time ``t`` between padded float32 NCHW frames."""
    s = model["flow_scale"]
    x = torch.cat([x1, x2], 1)
    if s > 1:
        x = F.avg_pool2d(x, s)
    y = nets.unet(x, p, "motion_unet", model["depth"], model["upsample"], q)
    flow, logit = y[:, :2], y[:, 2:3]
    if s > 1:
        size = x1.shape[-2:]
        flow = F.interpolate(flow * float(s), size=size, mode="bilinear",
                             align_corners=False)
        logit = F.interpolate(logit, size=size, mode="bilinear",
                              align_corners=False)
    m = torch.sigmoid(logit)
    g0 = nets.shifts_warp(x1, -t * flow, model["max_flow"])
    g1 = nets.shifts_warp(x2, (1.0 - t) * flow, model["max_flow"])
    w0, w1 = (1.0 - t) * m, t * (1.0 - m)
    out = (w0 * g0 + w1 * g1) / (w0 + w1 + 1e-6)
    if model["refine_width"] > 0:
        out = out + nets.head(torch.cat([out, g0, g1, x1, x2], 1), p, q)
    return out


@torch.no_grad()
def inbetweens(p: nets.Params, f1_u8: torch.Tensor, f2_u8: torch.Tensor,
               model: dict, n: int = 1, q: nets.Quant = None) -> torch.Tensor:
    """uint8 [B,H,W,C] pairs -> uint8 [B,n,H,W,C]: the frames at the exact
    times i/(n+1)."""
    _check(model)
    h, w = f1_u8.shape[1:3]
    m = nets.pad_multiple(model)
    x1 = nets.pad_edge(nets.normalize(f1_u8), m)
    x2 = nets.pad_edge(nets.normalize(f2_u8), m)
    with nets.no_tf32():
        return torch.stack([
            nets.to_uint8(predict(p, x1, x2, (i + 1) / (n + 1), model,
                                  q)[..., :h, :w]) for i in range(n)], 1)
