"""The flow family in PyTorch (JAX ``models/flow.py``).

A U-Net motion backbone (``motion_unet``) predicts, per pixel, one motion
field ``F`` (frame1 -> frame2, pixels) and a blend mask ``m``; a sampler
makes the frame at any time ``t`` from two backward warps and a
time-weighted blend (``ops/warp_fused.py``), and an optional full-resolution
refinement head (``refine1``, ``refine2``, ``refine_out``) corrects it from
``concat(out, g0, g1, f1, f2)``. With ``flow_scale = s > 1`` the backbone
sees ``s x s`` average-pooled frames and its field is resized back
(half-pixel grid) with the displacements scaled by ``s``.

Layout is NCHW at the module's methods; the sampler and the head take NHWC
views of the same memory (for gray frames the two layouts coincide). On
the card the sampler and the head are the ``sample_fused`` and
``refine_head`` CUDA kernels. Ported: the single-field ``shifts`` path. The
bidirectional field, the cascade and the other warps raise
``NotImplementedError`` on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.refine import pack_head_weights, refine_head
from ..ops.resize import resize_bilinear
from ..ops.warp_fused import sample_fused
from .unet import UNet


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class FlowInterpolator(nn.Module):
    """Two frames in, the frame at time ``t`` out (NCHW), with separable
    ``motion`` and ``sample`` steps so one backbone pass serves many
    sample times."""

    def __init__(self, cfg: ModelConfig = ModelConfig(arch="flow"),
                 compute_dtype=torch.bfloat16, folded: bool = False):
        super().__init__()
        if cfg.space_to_depth != 1:
            raise ValueError("arch='flow' predicts a pixel-space motion "
                             "field; space_to_depth must be 1")
        if cfg.flow_scale < 1:
            raise ValueError("flow_scale must be >= 1")
        if cfg.flow_bidir:
            raise NotImplementedError("flow_bidir is not ported yet (ROADMAP "
                                      "Queue A item 8, bidirectional field)")
        if cfg.flow_cascade > 0:
            raise NotImplementedError("flow_cascade is not ported yet "
                                      "(ROADMAP Queue A item 8, cascade)")
        if cfg.warp_impl != "shifts":
            raise NotImplementedError(
                f"warp_impl={cfg.warp_impl!r} is not ported yet (ROADMAP "
                "Queue A item 8); the port has the 'shifts' warp")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.folded = folded
        self.motion_unet = UNet(cfg.in_frames * cfg.channels, 3,
                                cfg.base_width, cfg.depth, cfg.bilinear,
                                folded, cfg.upsample)
        if cfg.refine_width > 0:
            w, c = cfg.refine_width, cfg.channels
            self.refine1 = nn.Conv2d(5 * c, w, 3, padding=1)
            self.refine2 = nn.Conv2d(w, w, 3, padding=1)
            self.refine_out = nn.Conv2d(w, c, 1)
        self.packed_head: Optional[dict] = None

    def head_params(self) -> dict:
        """The refinement head's weights, ``{name: {"weight", "bias"}}``."""
        return {n: {"weight": getattr(self, n).weight,
                    "bias": getattr(self, n).bias}
                for n in ("refine1", "refine2", "refine_out")}

    def pack_head(self) -> None:
        """Build the head kernel's weight layouts once (as
        ``FrameInterpolationUNet.pack_head``)."""
        self.packed_head = pack_head_weights(
            self.head_params(), self.compute_dtype) \
            if self.cfg.refine_width > 0 else None

    def motion(self, frame1: torch.Tensor, frame2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One backbone pass: (flow [B,2,H,W] f32 in pixels, channel 0 the x
        displacement; mask [B,1,H,W] f32 in (0, 1)), at full resolution."""
        s = self.cfg.flow_scale
        x = torch.cat([frame1, frame2], 1)
        if s > 1:
            x = F.avg_pool2d(x.float(), s).to(x.dtype)
        y = self.motion_unet(x, self.compute_dtype)     # f32 output conv
        flow, logit = y[:, :2], y[:, 2:3]
        if s > 1:
            hw = (frame1.shape[-2], frame1.shape[-1])
            flow = resize_bilinear(flow * float(s), hw, align_corners=False)
            logit = resize_bilinear(logit, hw, align_corners=False)
        return flow, torch.sigmoid(logit)

    def sample_parts(self, frame1, frame2, flow, mask, t):
        """The warps and the blend without the head: ``(out, g0, g1)``,
        each [B,C,H,W] f32 (NCHW views of NHWC memory). ``t`` is [B]."""
        cdt = self.compute_dtype
        parts = sample_fused(_nhwc(frame1.to(cdt)), _nhwc(frame2.to(cdt)),
                             _nhwc(flow), _nhwc(mask), t.float(),
                             self.cfg.max_flow)
        return tuple(_nchw(p) for p in parts)

    def refine(self, out, g0, g1, frame1, frame2) -> torch.Tensor:
        """The refinement head alone over ``concat(out, g0, g1, f1, f2)``
        (``out`` unchanged without a head)."""
        if self.cfg.refine_width <= 0:
            return out
        cdt = self.compute_dtype
        y = refine_head(_nhwc(out), tuple(_nhwc(p) for p in (
            g0, g1, frame1.to(cdt), frame2.to(cdt))), self.head_params(), cdt,
            self.packed_head)
        return _nchw(y)

    def sample(self, frame1, frame2, flow, mask, t) -> torch.Tensor:
        """The frame at times ``t`` ([B] in [0, 1]) from a precomputed
        field: the sampler, then the head."""
        out, g0, g1 = self.sample_parts(frame1, frame2, flow, mask, t)
        return self.refine(out, g0, g1, frame1, frame2)

    def forward(self, frame1: torch.Tensor, frame2: torch.Tensor,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if t is None:
            t = torch.full((frame1.shape[0],), 0.5, dtype=torch.float32,
                           device=frame1.device)
        flow, mask = self.motion(frame1, frame2)
        return self.sample(frame1, frame2, flow, mask, t)
