"""Padding, cropping, the decoder's 2x bilinear upsamples and the
arbitrary-size bilinear resize (JAX ``ops/resize.py``).

The port works in NCHW: every function here takes ``[..., H, W]`` with the
spatial axes last. The JAX functions take NHWC; tests transpose.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _align_corners_taps(n: int, rows: Optional[Tuple[int, int]] = None):
    """(lo, hi, w) of the x2 align-corners grid: out[o] = (1-w) x[lo] +
    w x[hi], with the source coordinate taken in float64 as the JAX package
    does (``F.interpolate`` takes it in f32, which moves the weights by up
    to ~n * 2^-24 and the output by a few 1e-6).

    ``rows=(first, total)``: the ``n`` rows are a window, from row
    ``first``, of a map of ``total`` rows. The taps are then the whole
    map's for the window's output rows ``[2 first, 2 (first + n))``,
    indexed into the window and clamped to it (a clamped tap lands in the
    window's halo, which its caller crops away)."""
    first, total = rows if rows is not None else (0, n)
    src = (np.arange(2 * first, 2 * (first + n), dtype=np.float64)
           * (total - 1) / max(2 * total - 1, 1))
    lo = np.clip(np.floor(src), 0, total - 1).astype(np.int64)
    hi = np.minimum(lo + 1, total - 1)
    w = (src - lo).astype(np.float32)
    return (np.clip(lo - first, 0, n - 1), np.clip(hi - first, 0, n - 1), w)


def _lerp_axis(x: torch.Tensor, axis: int,
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    lo, hi, w = _align_corners_taps(x.shape[axis], rows)
    shape = [1] * x.ndim
    shape[axis] = w.size
    wt = torch.from_numpy(w).to(x.device).view(shape)
    xf = x.float()
    out = (xf.index_select(axis, torch.from_numpy(lo).to(x.device)) * (1.0 - wt)
           + xf.index_select(axis, torch.from_numpy(hi).to(x.device)) * wt)
    return out.to(x.dtype)


def upsample2x_align_corners(x: torch.Tensor,
                             rows: Optional[Tuple[int, int]] = None
                             ) -> torch.Tensor:
    """x2 bilinear, ``align_corners=True`` (reference ``nn.Upsample``),
    as an exact two-tap lerp per axis. ``rows=(first, total)``: ``x`` holds
    rows ``[first, first + H)`` of a map of ``total`` rows (a height split's
    window), and the H axis takes the whole map's taps
    (:func:`_align_corners_taps`); W is never split."""
    return _lerp_axis(_lerp_axis(x, x.ndim - 2, rows), x.ndim - 1)


def upsample2x_half_pixel(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear with half-pixel centers: ``out[2i] = 0.25 x[i-1] +
    0.75 x[i]``, ``out[2i+1] = 0.75 x[i] + 0.25 x[i+1]``, edge-clamped; the
    same grid as ``F.interpolate(align_corners=False)``."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def reach_half_pixel(iv: Tuple[int, int], s: int) -> Tuple[int, int]:
    """The output rows that input rows ``iv = (lo, hi)`` reach through a
    bilinear x``s`` on the half-pixel grid, edge-clamped (the decoder's
    ``half_pixel`` upsample, the polyphase and up-block kernels' fused one,
    the flow field's resize): out[o] reads rows floor(src), floor(src) + 1
    with src = (o + 1/2)/s - 1/2, so row j reaches the o with src in
    [j - 1, j + 1). For a height split's halo
    (``parallel/sharding.py:halo_rows``)."""
    lo, hi = (2 * iv[0] - 1) * s - 1, (2 * iv[1] + 3) * s - 1
    return -(-lo // 2), -(-hi // 2) - 1     # ceil(lo / 2), ceil(hi / 2) - 1


def reach_align_corners(iv: Tuple[int, int]) -> Tuple[int, int]:
    """As :func:`reach_half_pixel`, through :func:`upsample2x_align_corners`:
    src = o/2 - o/(2(2n-1)) lies in (o/2 - 1/2, o/2] for the rows o of the
    frame, so row j, read where src is in [j - 1, j + 1), reaches the o in
    [2j - 1, 2j + 2], whatever the frame's height."""
    return 2 * iv[0] - 1, 2 * iv[1] + 2


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
