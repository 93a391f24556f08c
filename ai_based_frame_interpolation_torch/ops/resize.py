"""Padding, cropping, the decoder's 2x bilinear upsamples and the
arbitrary-size bilinear resize (JAX ``ops/resize.py``).

The port works in NCHW: every function here takes ``[..., H, W]`` with the
spatial axes last. The JAX functions take NHWC; tests transpose.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _align_corners_taps(n: int):
    """(lo, hi, w) of the x2 align-corners grid: out[o] = (1-w) x[lo] +
    w x[hi], with the source coordinate taken in float64 as the JAX package
    does (``F.interpolate`` takes it in f32, which moves the weights by up
    to ~n * 2^-24 and the output by a few 1e-6)."""
    src = np.arange(2 * n, dtype=np.float64) * (n - 1) / max(2 * n - 1, 1)
    lo = np.clip(np.floor(src), 0, n - 1).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _lerp_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    lo, hi, w = _align_corners_taps(x.shape[axis])
    shape = [1] * x.ndim
    shape[axis] = w.size
    wt = torch.from_numpy(w).to(x.device).view(shape)
    xf = x.float()
    out = (xf.index_select(axis, torch.from_numpy(lo).to(x.device)) * (1.0 - wt)
           + xf.index_select(axis, torch.from_numpy(hi).to(x.device)) * wt)
    return out.to(x.dtype)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear, ``align_corners=True`` (reference ``nn.Upsample``),
    as an exact two-tap lerp per axis."""
    return _lerp_axis(_lerp_axis(x, x.ndim - 2), x.ndim - 1)


def upsample2x_half_pixel(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear with half-pixel centers: ``out[2i] = 0.25 x[i-1] +
    0.75 x[i]``, ``out[2i+1] = 0.75 x[i] + 0.25 x[i+1]``, edge-clamped; the
    same grid as ``F.interpolate(align_corners=False)``."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of ``[B,C,H,W]`` to ``out_hw``: the JAX function's
    grid (torch ``F.interpolate`` semantics at the target size, which is
    what the JAX golden test holds it to)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def _edge_index(n: int, pad: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n + pad, device=device), max=n - 1)


def pad_to_multiple(x: torch.Tensor, multiple: int = 16):
    """Edge-pad H and W (the last two axes) up to a multiple at the bottom
    and right; returns ``(padded, (H, W))``."""
    h, w = x.shape[-2], x.shape[-1]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph:
        x = x.index_select(-2, _edge_index(h, ph, x.device))
    if pw:
        x = x.index_select(-1, _edge_index(w, pw, x.device))
    return x, (h, w)


def crop_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Undo :func:`pad_to_multiple`."""
    h, w = hw
    return x[..., :h, :w]
