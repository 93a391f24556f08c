"""The tower family in PyTorch (JAX ``models/tower.py``).

A shared frame encoder (the same weights on each frame) makes a feature
pyramid per frame; a fusion decoder concatenates the two pyramids scale by
scale and decodes the prediction as the U-Net's decoder does. So a video
stream encodes each frame once and both adjacent pairs reuse its pyramid
(``InterpolationEngine``'s tower stream slices one batched encode). With
``slim_decoder`` a 1x1 projection brings each fused skip back to the
encoder's width; with ``time_conditioned`` a constant-t plane joins the
fused bottleneck.

Layout is NCHW. Module names follow the Flax module paths
(``encoder.inc``, ``encoder.down{i}``, ``decoder.proj{j}``,
``decoder.up{i}``, ``decoder.outc``, ``refine1``, ``refine2``,
``refine_out``) and the blocks are the U-Net's ``DoubleConv``, so a Flax
variables tree maps onto the ``state_dict`` key for key
(``models/bridge.py``) and ``fold_batchnorm`` folds the tower too.
Precision as ``models/unet.py``. The head is the U-Net's dense head
(the JAX tower has no depthwise head): at ``refine_factor=1`` it runs the
``refine_head`` kernel on the card with weights packed once.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.resize import (reach_align_corners, reach_half_pixel,
                          upsample2x_align_corners, upsample2x_half_pixel)
from .unet import (DoubleConv, Reach, RefineHead, conv, depth_to_space, hull,
                   level_rows, reach_conv, reach_down, space_to_depth)


def _widths(base_width: int, depth: int) -> List[int]:
    """The encoder's pyramid widths: w, 2w, ..., with a halved bottleneck."""
    return [base_width * 2 ** i for i in range(depth)] + \
        [base_width * 2 ** depth // 2]


class FrameEncoder(nn.Module):
    """Per-frame feature pyramid (the U-Net encoder at half width)."""

    def __init__(self, in_ch: int, base_width: int = 32, depth: int = 4,
                 folded: bool = False):
        super().__init__()
        widths = _widths(base_width, depth)
        self.depth = depth
        self.inc = DoubleConv(in_ch, widths[0], folded=folded)
        for i in range(1, depth + 1):
            setattr(self, f"down{i}",
                    DoubleConv(widths[i - 1], widths[i], folded=folded))

    def forward(self, x: torch.Tensor, cdt, train: bool = False
                ) -> List[torch.Tensor]:
        feats = [self.inc(x, cdt, train)]
        for i in range(1, self.depth + 1):
            feats.append(getattr(self, f"down{i}")(F.max_pool2d(feats[-1], 2),
                                                   cdt, train))
        return feats

    def row_reach(self, iv: Reach) -> List[Reach]:
        feats = [self.inc.row_reach(iv)]
        for i in range(1, self.depth + 1):
            feats.append(getattr(self, f"down{i}").row_reach(
                reach_down(feats[-1], 2)))
        return feats


class FusionDecoder(nn.Module):
    """Scale-wise fusion (concat) of two pyramids, then U-Net decoding to
    ``out_channels`` by an f32 1x1 conv."""

    def __init__(self, out_channels: int = 1, base_width: int = 32,
                 depth: int = 4, time_conditioned: bool = False,
                 folded: bool = False, slim: bool = False,
                 upsample: str = "align_corners"):
        super().__init__()
        if upsample not in ("align_corners", "half_pixel"):
            raise ValueError(f"unknown upsample mode {upsample!r}")
        self.depth = depth
        self.time_conditioned = time_conditioned
        self.slim = slim
        self.upsample = upsample
        fused = [2 * c for c in _widths(base_width, depth)]
        if slim:
            for j, c in enumerate(fused):
                setattr(self, f"proj{j}", nn.Conv2d(c, c // 2, 1))
            fused = [c // 2 for c in fused]
        y_ch = fused[-1] + (1 if time_conditioned else 0)
        # fused widths match the reference U-Net's; slim halves them back
        w2 = base_width * (1 if slim else 2)
        for i in range(1, depth + 1):
            ch = w2 * 2 ** (depth - i)
            if i < depth:
                ch //= 2
            cat = fused[depth - i] + y_ch
            setattr(self, f"up{i}", DoubleConv(cat, ch, cat // 2,
                                               folded=folded))
            y_ch = ch
        self.outc = nn.Conv2d(y_ch, out_channels, 1)

    def forward(self, feats1: List[torch.Tensor], feats2: List[torch.Tensor],
                t: Optional[torch.Tensor], cdt, train: bool = False,
                rows: Optional[tuple] = None) -> torch.Tensor:
        """``rows=(first, total)`` of the finest level, as
        ``models/unet.py:UNet.forward`` takes them."""
        fused = [torch.cat([a, b], 1) for a, b in zip(feats1, feats2)]
        if self.slim:
            fused = [F.relu(conv(f, getattr(self, f"proj{j}"), cdt))
                     for j, f in enumerate(fused)]
        y = fused[-1]
        if self.time_conditioned:
            b, _, h, w = y.shape
            if t is None:
                t = torch.full((b,), 0.5, dtype=torch.float32, device=y.device)
            y = torch.cat([y, t.to(y.dtype).view(b, 1, 1, 1).expand(
                b, 1, h, w)], 1)
        for i in range(1, self.depth + 1):
            y = upsample2x_half_pixel(y) if self.upsample == "half_pixel" \
                else upsample2x_align_corners(
                    y, level_rows(rows, 2 ** (self.depth - i + 1)))
            skip = fused[self.depth - i]
            dh = skip.shape[-2] - y.shape[-2]
            dw = skip.shape[-1] - y.shape[-1]
            if dh or dw:
                y = F.pad(y, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            y = getattr(self, f"up{i}")(torch.cat([skip, y.to(skip.dtype)], 1),
                                        cdt, train)
        return conv(y, self.outc, torch.float32)

    def row_reach(self, feats: List[Reach]) -> Reach:
        """From the reach into each level of the pyramids."""
        if self.slim:
            feats = [reach_conv(f, getattr(self, f"proj{j}"))
                     for j, f in enumerate(feats)]
        y = feats[-1]
        for i in range(1, self.depth + 1):
            y = reach_half_pixel(y, 2) if self.upsample == "half_pixel" \
                else reach_align_corners(y)
            y = getattr(self, f"up{i}").row_reach(hull(feats[self.depth - i],
                                                       y))
        return reach_conv(y, self.outc)


class TowerInterpolator(RefineHead, nn.Module):
    """Two frames in, the midpoint (or the frame at ``t``) out, NCHW, with
    separable :meth:`encode` and :meth:`decode` for the engine's stream."""

    def __init__(self, cfg: ModelConfig = ModelConfig(arch="tower"),
                 compute_dtype=torch.bfloat16, folded: bool = False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.folded = folded
        r, g = cfg.space_to_depth, cfg.refine_factor
        cr = cfg.channels * r * r
        self.encoder = FrameEncoder(cr, cfg.base_width // 2, cfg.depth, folded)
        self.decoder = FusionDecoder(cr, cfg.base_width // 2, cfg.depth,
                                     cfg.time_conditioned, folded,
                                     cfg.slim_decoder, cfg.upsample)
        self.has_head = cfg.refine_width > 0 and r > 1
        if self.has_head:
            if r % g:
                raise ValueError(
                    f"refine_factor {g} must divide space_to_depth {r}")
            w = cfg.refine_width
            cg = cfg.channels * g * g
            self.refine1 = nn.Conv2d(3 * cg, w, 3, padding=1)
            self.refine2 = nn.Conv2d(w, w, 3, padding=1)
            self.refine_out = nn.Conv2d(w, cg, 1)
        self.head_names = ("refine1", "refine2", "refine_out")
        self.packed_head: Optional[dict] = None

    def encode(self, frame: torch.Tensor, train: bool = False
               ) -> List[torch.Tensor]:
        """One frame batch's feature pyramid, in the compute dtype."""
        cdt = self.compute_dtype
        x = space_to_depth(frame, self.cfg.space_to_depth).to(cdt)
        return self.encoder(x, cdt, train)

    def decode(self, feats1: List[torch.Tensor], feats2: List[torch.Tensor],
               f1: torch.Tensor, f2: torch.Tensor,
               t: Optional[torch.Tensor] = None, train: bool = False,
               rows: Optional[tuple] = None) -> torch.Tensor:
        """The prediction from two pyramids and their frames (the residual
        base and the head's planes); ``train`` as in ``models/unet.py``;
        ``rows`` as ``FrameInterpolationUNet.forward`` takes them."""
        cfg = self.cfg
        r = cfg.space_to_depth
        y = self.decoder(feats1, feats2, t, self.compute_dtype, train,
                         level_rows(rows, r))
        if cfg.residual:
            y = y + 0.5 * (space_to_depth(f1, r) +
                           space_to_depth(f2, r)).to(y.dtype)
        if self.has_head:
            g = cfg.refine_factor
            return self.head(y, space_to_depth(f1, g), space_to_depth(f2, g),
                             train)
        return depth_to_space(y, r)

    def forward(self, frame1: torch.Tensor, frame2: torch.Tensor,
                t: Optional[torch.Tensor] = None, train: bool = False,
                rows: Optional[tuple] = None) -> torch.Tensor:
        return self.decode(self.encode(frame1, train),
                           self.encode(frame2, train), frame1, frame2, t,
                           train, rows)

    def row_reach(self, p: int) -> Reach:
        """As ``FrameInterpolationUNet.row_reach``, for one decode over
        both frames' pyramids."""
        x = reach_down((p, p), self.cfg.space_to_depth)
        y = self.decoder.row_reach(self.encoder.row_reach(x))
        if self.cfg.residual:
            y = hull(y, x)
        return self.head_reach(y, p)
