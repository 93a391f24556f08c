"""Backward warping by a flow field, plain PyTorch (JAX ``ops/warp.py``).

Two of its semantics are ported. ``gather4`` is the exact bilinear warp
(the sample point clipped to the image, border replicate), which the
trainer's flow photometric loss uses (JAX ``train/loop.py:134-145``).
``shifts`` is the separable warp the flow family trains through. Per axis, ``out[p] = img[p + clip(disp[p], -max_flow,
max_flow)]``, linearly interpolated, the position clipped to ``[0, size-1]``
(border replicate); the X pass runs first, then the Y pass over its
result, so the Y pass reads X-warped rows that used the x displacement at
the SOURCE row, not at the output row. The JAX package builds each pass
from ``2*max_flow + 2`` statically shifted copies (a TPU workaround for
gathers); here each pass is the same two taps read directly, in f32. This
is the plain half of the flow sampler (``ops/warp_fused.py``), not a route
on the card.
"""

from __future__ import annotations

import torch

_NOT_PORTED = ("warp_impl={!r} is not ported yet (ROADMAP Queue A, the "
               "remaining model options); the port has the 'shifts' and "
               "'gather4' warps")


def _warp_axis(img: torch.Tensor, disp: torch.Tensor, axis: int,
               rmax: int) -> torch.Tensor:
    """1-D bounded warp of f32 ``img`` [B,H,W,C] along ``axis`` (1 = H,
    2 = W) by ``disp`` [B,H,W]: ``(1-f) img[k0] + f img[min(k0+1, n-1)]``
    with ``pos = grid + clip(disp)`` clipped to the image, ``k0 = floor``."""
    size = img.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = size
    grid = torch.arange(size, dtype=torch.float32,
                        device=img.device).view(shape)
    pos = torch.clamp(grid + torch.clamp(disp, -rmax, rmax), 0.0, size - 1)
    k0f = torch.floor(pos)
    frac = (pos - k0f).unsqueeze(-1)
    k0 = k0f.long()
    k1 = torch.clamp(k0 + 1, max=size - 1)
    idx = [k.unsqueeze(-1).expand(img.shape) for k in (k0, k1)]
    return (torch.gather(img, axis, idx[0]) * (1.0 - frac)
            + torch.gather(img, axis, idx[1]) * frac)


def _warp_gather4(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The exact bilinear warp of f32 ``img`` [B,H,W,C]: the sample point
    clipped to the image first, the top-left corner at most (H-2, W-2),
    the four corners blended along x, then along y."""
    b, h, w, c = img.shape
    dev = img.device
    x = torch.clamp(torch.arange(w, dtype=torch.float32, device=dev)
                    .view(1, 1, w) + flow[..., 0], 0.0, w - 1)
    y = torch.clamp(torch.arange(h, dtype=torch.float32, device=dev)
                    .view(1, h, 1) + flow[..., 1], 0.0, h - 1)
    x0 = torch.clamp(torch.floor(x), max=w - 2)
    y0 = torch.clamp(torch.floor(y), max=h - 2)
    wx = (x - x0).unsqueeze(-1)
    wy = (y - y0).unsqueeze(-1)
    flat = img.reshape(b, h * w, c)
    base = y0.long() * w + x0.long()

    def fetch(offset):
        idx = (base + offset).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    top = fetch(0) * (1 - wx) + fetch(1) * wx
    bot = fetch(w) * (1 - wx) + fetch(w + 1) * wx
    return top * (1 - wy) + bot * wy


def backward_warp(img: torch.Tensor, flow: torch.Tensor, impl: str = "shifts",
                  max_flow: int = 32) -> torch.Tensor:
    """Sample ``img`` [B,H,W,C] at ``(y + dy, x + dx)`` with the ``shifts``
    or the ``gather4`` semantics (module docstring; ``max_flow`` bounds the
    shifts warp only). ``flow`` [B,H,W,2] holds (dx, dy) in pixels.
    Returns f32 [B,H,W,C]; differentiable in ``img`` and ``flow``."""
    if impl not in ("shifts", "gather4"):
        raise NotImplementedError(_NOT_PORTED.format(impl))
    _, h, w, _ = img.shape
    if h < 2 or w < 2:
        raise ValueError(f"backward_warp needs H, W >= 2, got {(h, w)}")
    flow = flow.float()
    if impl == "gather4":
        return _warp_gather4(img.float(), flow)
    hx = _warp_axis(img.float(), flow[..., 0], 2, max_flow)
    return _warp_axis(hx, flow[..., 1], 1, max_flow)
