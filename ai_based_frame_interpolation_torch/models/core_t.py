"""The U-Net engine's option core (JAX ``models/core_t.py``).

A folded-inference forward of the s2d U-Net up to and including the
residual add (the ``skip_refine=True`` contract of
``FrameInterpolationUNet``) that runs the five outer DoubleConv blocks on
the hand-written kernels of ``ops/dconv_fused.py``:

    stem: s2d + concat, channels-last          [B, H0, W0, C0]
      inc -> pool -> down1 -> pool -> down2    double_conv_fused
        down3 / down4 / up1 / up2              the port's Down/Up (cuDNN)
      up3 -> up4                               up_double_conv_fused (half
                                               pixel), or the composed
                                               upsample + double_conv_fused
      outc (f32), residual, depth_to_space     [B, C, H, W] f32

Activations stay channels-last from the stem to ``outc``: the kernels'
implicit GEMMs contract over contiguous channels, and the deep middle takes
channels-last views (cuDNN runs its bf16 convs channels-last anyway). The
JAX core lays its tensors out width-on-lanes and pads widths and the
``down2`` rows for the TPU's tiles; the port needs neither.

The engine routes here with ``core_impl="auto"`` (on the card, when
:func:`eligible` holds) or ``"pallas"`` (forced; on CPU tensors the kernels'
plain versions run). The default ``"xla"`` runs the model's own forward.
"""

from __future__ import annotations

import functools

import torch

from ..config import ModelConfig
from ..ops.dconv_fused import (double_conv_fused, pack_dconv_weights,
                               up_double_conv_fused)
from ..ops.resize import _align_corners_taps
from .unet import depth_to_space, level_rows

# Max acceptable lane-padding ratio ceil128(w)/w at each transposed level.
_MAX_PAD_RATIO = 1.2


def _ceil128(w: int) -> int:
    return ((w + 127) // 128) * 128


def eligible(cfg: ModelConfig, height: int, width: int) -> bool:
    """Static routing predicate (padded full-res H, W), copied from the JAX
    package so that the port routes exactly where JAX routes.

    Requires the production core family (unet, bilinear decoder, depth 4,
    s2d>1, no time plane), 8-multiple channel widths, pool-exact heights,
    and lane-pad ratios <= ~1.07 at the three transposed widths — 1080p,
    and 4K s2d4 cores qualify; 720p/1440p (W1 pad ratio 1.6) and small
    inputs fall back to NHWC.

    The lane-ratio and width-join conditions are the TPU's 128-lane layout;
    the port's kernels take any width. They stay until a measured change
    drops them.
    """
    if getattr(cfg, "arch", "unet") != "unet" or not cfg.bilinear:
        return False
    if cfg.depth != 4 or cfg.space_to_depth < 2 or cfg.time_conditioned:
        return False
    r = cfg.space_to_depth
    if height % (16 * r) or width % (16 * r):
        return False
    h0, w0 = height // r, width // r
    c0 = 2 * cfg.channels * r * r
    if c0 % 8 or cfg.base_width % 8:
        return False
    if h0 % 16 or h0 < 32:
        return False
    for wt in (w0, w0 // 2, w0 // 4):
        if _ceil128(wt) / wt > _MAX_PAD_RATIO:
            return False
    # Decoder lane-width joins: each level's padded width must equal the
    # independently-rounded width of that level, or the up3/up4 skip
    # concats trace-fail on a width mismatch (e.g. w0=1360: input width
    # 5440 at s2d4 passes every pad-ratio check but 2*ceil128(w0/4)=768
    # != ceil128(w0)/2=704).
    if _ceil128(w0) // 2 != _ceil128(w0 // 2):
        return False
    if 2 * _ceil128(w0 // 4) != _ceil128(w0) // 2:
        return False
    return True


def _weights(dc) -> tuple:
    """(w1, b1, w2, b2) of a folded ``DoubleConv``."""
    return dc.conv1.weight, dc.conv1.bias, dc.conv2.weight, dc.conv2.bias


def _blocks(model) -> dict:
    u = model.unet
    return {"inc": u.inc, "down1": u.down1.conv, "down2": u.down2.conv,
            "up3": u.up3.conv, "up4": u.up4.conv}


def pack_core_weights(model) -> dict:
    """The kernels' weight layouts of the five outer blocks, by level
    (``ops.dconv_fused.pack_dconv_weights``), from the folded model's
    weights as placed now, in the model's compute dtype. With the half-pixel decoder ``up3`` and ``up4``
    run the up-block kernel, whose w1 is split at the skip's channels; the
    align-corners decoder runs them as a double conv of the concat."""
    if not model.folded:
        raise ValueError("the option core needs folded BatchNorm weights")
    u = model.unet
    split = {}
    if model.cfg.upsample == "half_pixel":
        split = {"up3": u.down1.conv.conv2.out_channels,
                 "up4": u.inc.conv2.out_channels}
    return {name: pack_dconv_weights(*_weights(dc), split=split.get(name),
                                     compute_dtype=model.compute_dtype)
            for name, dc in _blocks(model).items()}


def _s2d_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B,C,H,W] -> [B,H/r,W/r,r*r*C], channels in JAX's (dy, dx, c) order
    (``models.unet.space_to_depth``, channels-last)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // r, r, w // r, r)
    return x.permute(0, 2, 4, 3, 5, 1).reshape(b, h // r, w // r, r * r * c)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of [B,H,W,C] (H and W even)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


@functools.lru_cache(maxsize=32)
def _align_corners_taps_t(n: int, rows, dtype: torch.dtype,
                          device: torch.device):
    """(lo, hi, bf16(1 - w), bf16(w)) of the x2 align-corners lerp over
    ``n`` rows (a window's, with ``rows``: ``ops/resize.py``), the weights
    rounded to ``dtype`` and kept f32 (the lo == hi edge rows sum to 1),
    placed on ``device`` once per shape."""
    lo, hi, w = _align_corners_taps(n, rows)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(1.0 - w).to(dtype).float().to(device),
            torch.from_numpy(w).to(dtype).float().to(device))


def _upsample2x_t(x: torch.Tensor, rows=None) -> torch.Tensor:
    """x2 align-corners bilinear of [B,H,W,C], as the JAX core composes it
    (``core_t.py:_upsample2x_t``): along W a two-tap product with the
    weights rounded to the input's dtype first (its W matrix), f32 sums,
    rounded; then along H the two-tap lerp with the weights rounded to the
    input's dtype, in f32, rounded. ``rows=(first, total)``: ``x`` is a
    height split's window (``ops/resize.py:upsample2x_align_corners``)."""
    dt = x.dtype
    f = x.float()
    lo, hi, wlo, whi = _align_corners_taps_t(x.shape[2], None, dt, x.device)
    f = (f.index_select(2, lo) * wlo.view(1, 1, -1, 1)
         + f.index_select(2, hi) * whi.view(1, 1, -1, 1)).to(dt).float()
    lo, hi, wlo, whi = _align_corners_taps_t(x.shape[1], rows, dt, x.device)
    f = (f.index_select(1, lo) * wlo.view(1, -1, 1, 1)
         + f.index_select(1, hi) * whi.view(1, -1, 1, 1))
    return f.to(dt)


def forward_pre_refine(model, x1: torch.Tensor, x2: torch.Tensor,
                       rows=None) -> torch.Tensor:
    """Folded-inference forward up to and including the residual add, the
    ``skip_refine=True`` contract of ``FrameInterpolationUNet``: the
    normalized NCHW frames in, the f32 full-resolution NCHW prediction out.

    ``model`` is the port's folded ``FrameInterpolationUNet``. On the card
    its ``packed_core`` (:meth:`pack_core`, built once per model) holds the
    kernels' weight layouts, and the kernels raise without it; on CPU
    tensors the kernels' plain versions run. :func:`eligible` must hold for
    the input shape. ``rows`` as ``FrameInterpolationUNet.forward`` takes
    them (a height split's window).
    """
    cfg, cdt = model.cfg, model.compute_dtype
    r = cfg.space_to_depth
    u = model.unet
    packed = model.packed_core or {}
    blocks = _blocks(model)

    def dconv(name, x):
        return double_conv_fused(x, *_weights(blocks[name]), cdt,
                                 packed.get(name))

    def up_level(name, skip, low, scale):
        if cfg.upsample == "align_corners":
            return dconv(name, torch.cat(
                [skip, _upsample2x_t(low, level_rows(rows, scale))], -1))
        return up_double_conv_fused(skip, low, *_weights(blocks[name]), cdt,
                                    packed.get(name))

    f1, f2 = _s2d_nhwc(x1, r), _s2d_nhwc(x2, r)
    s0 = dconv("inc", torch.cat([f1.to(cdt), f2.to(cdt)], -1))
    s1 = dconv("down1", _pool2(s0))
    s2 = dconv("down2", _pool2(s1))

    # the deep middle on the port's modules, over channels-last views
    s2n = s2.permute(0, 3, 1, 2)
    s3 = u.down3(s2n, cdt)
    s4 = u.down4(s3, cdt)
    y = u.up1(s4, s3, cdt, rows=level_rows(rows, 16 * r))
    y = u.up2(y, s2n, cdt, rows=level_rows(rows, 8 * r))
    y = y.permute(0, 2, 3, 1).contiguous()

    y = up_level("up3", s1, y, 4 * r)
    y = up_level("up4", s0, y, 2 * r)

    ko = u.outc.weight.reshape(u.outc.out_channels, -1).float()
    yn = y.float() @ ko.t() + u.outc.bias.float()
    if cfg.residual:
        yn = yn + 0.5 * (f1 + f2).to(yn.dtype)
    return depth_to_space(yn.permute(0, 3, 1, 2), r)
