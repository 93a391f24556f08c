"""Backward warping by a flow field, plain PyTorch (JAX ``ops/warp.py``).

Only the ``shifts`` semantics are ported: the separable warp the flow
family trains through. Per axis, ``out[p] = img[p + clip(disp[p], -max_flow,
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

_NOT_PORTED = ("warp_impl={!r} is not ported yet (ROADMAP Queue A item 8); "
               "the port has the 'shifts' warp")


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


def backward_warp(img: torch.Tensor, flow: torch.Tensor, impl: str = "shifts",
                  max_flow: int = 32) -> torch.Tensor:
    """Sample ``img`` [B,H,W,C] at ``(y + dy, x + dx)`` with the shifts
    semantics (module docstring). ``flow`` [B,H,W,2] holds (dx, dy) in
    pixels. Returns f32 [B,H,W,C]."""
    if impl != "shifts":
        raise NotImplementedError(_NOT_PORTED.format(impl))
    _, h, w, _ = img.shape
    if h < 2 or w < 2:
        raise ValueError(f"backward_warp needs H, W >= 2, got {(h, w)}")
    flow = flow.float()
    hx = _warp_axis(img.float(), flow[..., 0], 2, max_flow)
    return _warp_axis(hx, flow[..., 1], 1, max_flow)
