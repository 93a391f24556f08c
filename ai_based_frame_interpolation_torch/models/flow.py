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
views of the same memory (for gray frames the two layouts coincide).

The options of the JAX model are all here. ``flow_bidir`` predicts a
second, independent field ``F10`` (channels 2-3 of the field) and samples
with the Super-SloMo fields ``F_t0 = -(1-t) t F01 + t^2 F10``, ``F_t1 =
(1-t)^2 F01 - t (1-t) F10``. ``flow_cascade = K`` adds K residual stages
after the resize (``cascade{k}_1``, ``cascade{k}_2``, ``cascade{k}_out``):
each warps both frames to the midpoint with the current field and adds a
correction to the field and the mask logit. ``warp_impl`` picks the warp
(``ops/warp.py``).

On the card the head is the ``refine_head`` CUDA kernel. The sampler is
the ``sample_fused`` kernel where it computes the config's warps (the
single-field shifts warp, ``warp_fused.config_eligible``, the cascade
included); for the bidirectional field and the other warps the two warps
and the blend are stock PyTorch, as the JAX package runs them in XLA.
The cascade's warps and convs are stock PyTorch too.

With ``train=True`` (the JAX package's training forward) the backbone's
BatchNorm takes the batch's statistics (``models/unet.py:batch_norm``),
and the sampler and the head are plain PyTorch under autograd: two
``ops/warp.py:backward_warp`` calls and the blend, then the head's own
convs, since neither kernel has a backward. The trainer takes the motion
field for its flow losses from :meth:`motion` and calls :meth:`sample`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.refine import pack_head_weights, refine_head
from ..ops.resize import resize_bilinear
from ..ops.warp import backward_warp
from ..ops.warp_fused import config_eligible, sample_fused
from .unet import UNet, conv


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
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.folded = folded
        nf = 4 if cfg.flow_bidir else 2
        self.motion_unet = UNet(cfg.in_frames * cfg.channels, nf + 1,
                                cfg.base_width, cfg.depth, cfg.bilinear,
                                folded, cfg.upsample)
        if cfg.refine_width > 0:
            w, c = cfg.refine_width, cfg.channels
            self.refine1 = nn.Conv2d(5 * c, w, 3, padding=1)
            self.refine2 = nn.Conv2d(w, w, 3, padding=1)
            self.refine_out = nn.Conv2d(w, c, 1)
        for k in range(cfg.flow_cascade):
            # over concat(f1, f2, g0, g1, field, mask logit); the out conv
            # is f32 and starts at zero (_init_weights), so each stage
            # starts as the identity
            setattr(self, f"cascade{k}_1",
                    nn.Conv2d(4 * cfg.channels + nf + 1, 32, 3, padding=1))
            setattr(self, f"cascade{k}_2", nn.Conv2d(32, 32, 3, padding=1))
            setattr(self, f"cascade{k}_out",
                    nn.Conv2d(32, nf + 1, 3, padding=1))
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

    def motion(self, frame1: torch.Tensor, frame2: torch.Tensor,
               train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """One backbone pass, then the cascade: (flow [B,2,H,W] f32 in
        pixels, channel 0 the x displacement, [B,4,H,W] under
        ``flow_bidir`` with ``F10`` in channels 2-3; mask [B,1,H,W] f32 in
        (0, 1)), at full resolution."""
        s = self.cfg.flow_scale
        nf = 4 if self.cfg.flow_bidir else 2
        x = torch.cat([frame1, frame2], 1)
        if s > 1:
            x = F.avg_pool2d(x.float(), s).to(x.dtype)
        y = self.motion_unet(x, self.compute_dtype, train)  # f32 output conv
        flow, logit = y[:, :nf], y[:, nf:nf + 1]
        if s > 1:
            hw = (frame1.shape[-2], frame1.shape[-1])
            flow = resize_bilinear(flow * float(s), hw, align_corners=False)
            logit = resize_bilinear(logit, hw, align_corners=False)
        for k in range(self.cfg.flow_cascade):
            flow, logit = self._cascade_step(k, frame1, frame2, flow, logit)
        return flow, torch.sigmoid(logit)

    def _cascade_step(self, k, frame1, frame2, flow, logit):
        """Stage ``k`` of the cascade (JAX ``_cascade_step``): both frames
        warped to t = 0.5 with the current field (``cfg.warp_impl``), a thin
        full-resolution net over ``concat(f1, f2, g0, g1, flow, logit)``,
        and its output added to the field and the mask logit."""
        cdt = self.compute_dtype
        nf = flow.shape[1]
        if self.cfg.flow_bidir:
            f01, f10 = flow[:, :2], flow[:, 2:4]
            ft0, ft1 = -0.25 * f01 + 0.25 * f10, 0.25 * f01 - 0.25 * f10
        else:
            ft0, ft1 = -0.5 * flow, 0.5 * flow
        a, b = frame1.to(cdt), frame2.to(cdt)
        g0, g1 = (_nchw(backward_warp(_nhwc(f), _nhwc(ft), self.cfg.warp_impl,
                                      self.cfg.max_flow))
                  for f, ft in ((a, ft0), (b, ft1)))
        z = torch.cat([a, b, g0.to(cdt), g1.to(cdt), flow.to(cdt),
                       logit.to(cdt)], 1)
        z = F.relu(conv(z, getattr(self, f"cascade{k}_1"), cdt))
        z = F.relu(conv(z, getattr(self, f"cascade{k}_2"), cdt))
        d = conv(z.float(), getattr(self, f"cascade{k}_out"), torch.float32)
        return flow + d[:, :nf], logit + d[:, nf:nf + 1]

    def sample_parts(self, frame1, frame2, flow, mask, t, train=False):
        """The warps and the blend without the head: ``(out, g0, g1)``,
        each [B,C,H,W] f32 (NCHW views of NHWC memory). ``t`` is [B]. The
        ``sample_fused`` wrapper where it computes this config's warps;
        otherwise, and with ``train``, two ``backward_warp`` calls
        (``cfg.warp_impl``) and the blend in stock PyTorch, as the JAX
        model's ``sample_parts``."""
        cdt = self.compute_dtype
        if not train and config_eligible(self.cfg):
            parts = sample_fused(_nhwc(frame1.to(cdt)), _nhwc(frame2.to(cdt)),
                                 _nhwc(flow), _nhwc(mask), t.float(),
                                 self.cfg.max_flow)
            return tuple(_nchw(p) for p in parts)
        tb = t.float().view(-1, 1, 1, 1)
        fl = _nhwc(flow).float()
        if self.cfg.flow_bidir:
            f01, f10 = fl[..., :2], fl[..., 2:4]
            ft0 = -(1.0 - tb) * tb * f01 + tb * tb * f10
            ft1 = (1.0 - tb) * (1.0 - tb) * f01 - tb * (1.0 - tb) * f10
        else:
            ft0, ft1 = -tb * fl, (1.0 - tb) * fl
        g0 = backward_warp(_nhwc(frame1.to(cdt)), ft0, self.cfg.warp_impl,
                           self.cfg.max_flow)
        g1 = backward_warp(_nhwc(frame2.to(cdt)), ft1, self.cfg.warp_impl,
                           self.cfg.max_flow)
        m = _nhwc(mask).float()
        w0 = (1.0 - tb) * m
        w1 = tb * (1.0 - m)
        out = (w0 * g0 + w1 * g1) / (w0 + w1 + 1e-6)
        return _nchw(out), _nchw(g0), _nchw(g1)

    def refine(self, out, g0, g1, frame1, frame2, train=False) -> torch.Tensor:
        """The refinement head alone over ``concat(out, g0, g1, f1, f2)``
        (``out`` unchanged without a head). With ``train``: the head's own
        convs under autograd, f32 out, as the JAX model's ``refine``."""
        if self.cfg.refine_width <= 0:
            return out
        cdt = self.compute_dtype
        if train:
            z = torch.cat([p.to(cdt) for p in (out, g0, g1, frame1, frame2)],
                          1)
            z = F.relu(conv(z, self.refine1, cdt))
            z = F.relu(conv(z, self.refine2, cdt))
            return out + conv(z.float(), self.refine_out, torch.float32)
        y = refine_head(_nhwc(out), tuple(_nhwc(p) for p in (
            g0, g1, frame1.to(cdt), frame2.to(cdt))), self.head_params(), cdt,
            self.packed_head)
        return _nchw(y)

    def sample(self, frame1, frame2, flow, mask, t, train=False
               ) -> torch.Tensor:
        """The frame at times ``t`` ([B] in [0, 1]) from a precomputed
        field: the sampler, then the head."""
        out, g0, g1 = self.sample_parts(frame1, frame2, flow, mask, t, train)
        return self.refine(out, g0, g1, frame1, frame2, train)

    def forward(self, frame1: torch.Tensor, frame2: torch.Tensor,
                t: Optional[torch.Tensor] = None, train: bool = False
                ) -> torch.Tensor:
        if t is None:
            t = torch.full((frame1.shape[0],), 0.5, dtype=torch.float32,
                           device=frame1.device)
        flow, mask = self.motion(frame1, frame2, train)
        return self.sample(frame1, frame2, flow, mask, t, train)
