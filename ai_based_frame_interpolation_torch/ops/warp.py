"""Backward warping by a flow field, plain PyTorch (JAX ``ops/warp.py``).

All four of its semantics are ported. ``gather4`` is the exact bilinear
warp (the sample point clipped to the image, border replicate), which the
trainer's flow photometric loss uses (JAX ``train/loop.py:134-145``);
``patch`` is numerically identical to it (JAX gathers 2x2 patches instead
of single corners, a TPU workaround), so it takes the same code.
``shifts`` is the separable warp the flow family trains through. Per axis,
``out[p] = img[p + clip(disp[p], -max_flow, max_flow)]``, linearly
interpolated, the position clipped to ``[0, size-1]`` (border replicate);
the X pass runs first, then the Y pass over its result, so the Y pass reads
X-warped rows that used the x displacement at the SOURCE row, not at the
output row. The JAX package builds each pass from ``2*max_flow + 2``
statically shifted copies (a TPU workaround for gathers); here each pass is
the same two taps read directly, in f32. This is the plain half of the flow
sampler (``ops/warp_fused.py``). ``pyramid`` splits each pass of the shifts
warp into a coarse integer shift by a multiple of a stride and a fine
shifts pass over the residual (:func:`_warp_axis_pyramid`); it is its own
trained-through approximation, so a pyramid model runs the pyramid math.
"""

from __future__ import annotations

import torch


def _grid(size: int, axis: int, device) -> torch.Tensor:
    """The f32 positions ``0..size-1`` along ``axis`` of a [B,H,W] field."""
    shape = [1, 1, 1]
    shape[axis] = size
    return torch.arange(size, dtype=torch.float32, device=device).view(shape)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the values of ``torch.clamp``, and under autograd its
    gradient too, which passes half at a bound where ``torch.clamp``
    passes all (the flow family trains through these clips)."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _take(img: torch.Tensor, axis: int, idx: torch.Tensor) -> torch.Tensor:
    """``img`` [B,H,W,C] read at the positions ``idx`` [B,H,W] along
    ``axis``, every channel."""
    return torch.gather(img, axis, idx.unsqueeze(-1).expand(img.shape))


def _warp_axis(img: torch.Tensor, disp: torch.Tensor, axis: int,
               rmax: int) -> torch.Tensor:
    """1-D bounded warp of f32 ``img`` [B,H,W,C] along ``axis`` (1 = H,
    2 = W) by ``disp`` [B,H,W]: ``(1-f) img[k0] + f img[min(k0+1, n-1)]``
    with ``pos = grid + clip(disp)`` clipped to the image, ``k0 = floor``."""
    size = img.shape[axis]
    grid = _grid(size, axis, img.device)
    pos = _clip(grid + _clip(disp, -rmax, rmax), 0.0, size - 1)
    k0f = torch.floor(pos)
    frac = (pos - k0f).unsqueeze(-1)
    k0 = k0f.long()
    k1 = torch.clamp(k0 + 1, max=size - 1)
    return (_take(img, axis, k0) * (1.0 - frac)
            + _take(img, axis, k1) * frac)


def _pyramid_stride(rmax: int) -> int:
    """The coarse stride with the fewest shifted copies in the JAX
    package's form of the pass (about ``sqrt(rmax / 2)``, at least 2)."""
    best, best_cost = 2, None
    for s in range(2, rmax + 1):
        cost = (2 * -(-rmax // s) + 1) + (2 * (s + (s + 1) // 2) + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _warp_axis_pyramid(img: torch.Tensor, disp: torch.Tensor, axis: int,
                       rmax: int) -> torch.Tensor:
    """The pyramid pass (JAX ``_warp_axis_pyramid``) as direct index
    arithmetic. With ``d`` the clipped displacement of :func:`_warp_axis`
    and ``s`` the stride: the coarse index ``kc = clip(round(d / s),
    +-ceil(rmax / s))`` (half to even, as ``jnp.round``); the image shifted
    by ``s * kc`` (edge-clamped); then the shifts pass with bound ``s +
    ceil(s / 2)`` over the residual ``d - s * kc_at``, where ``kc_at`` is
    ``kc`` re-read at ``p + clip(round(d - s * kc), +-ceil(s / 2))``, since
    the fine pass samples the coarse image there. Where the JAX package's
    form would take no fewer copies than the shifts pass (small bounds:
    ``max_flow`` 4), it is the shifts pass."""
    stride = _pyramid_stride(rmax)
    ncoarse = -(-rmax // stride)
    half = (stride + 1) // 2
    if (2 * ncoarse + 1) + (2 * (stride + half) + 2) >= 2 * rmax + 2:
        return _warp_axis(img, disp, axis, rmax)
    size = img.shape[axis]
    grid = _grid(size, axis, img.device)
    pos = _clip(grid + _clip(disp, -rmax, rmax), 0.0, size - 1)
    d = pos - grid
    kc = torch.clamp(torch.round(d / stride), -ncoarse, ncoarse)
    j0 = torch.clamp(torch.round(d - stride * kc), -half, half)
    p = grid.long()
    kc_at = torch.gather(kc, axis, torch.clamp(p + j0.long(), 0, size - 1))
    coarse = _take(img, axis,
                   torch.clamp(p + stride * kc.long(), 0, size - 1))
    return _warp_axis(coarse, d - stride * kc_at, axis, stride + half)


def _warp_gather4(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The exact bilinear warp of f32 ``img`` [B,H,W,C]: the sample point
    clipped to the image first, the top-left corner at most (H-2, W-2),
    the four corners blended along x, then along y."""
    b, h, w, c = img.shape
    dev = img.device
    x = _clip(torch.arange(w, dtype=torch.float32, device=dev)
              .view(1, 1, w) + flow[..., 0], 0.0, w - 1)
    y = _clip(torch.arange(h, dtype=torch.float32, device=dev)
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
    """Sample ``img`` [B,H,W,C] at ``(y + dy, x + dx)`` with the semantics of
    ``impl``: ``"shifts"``, ``"pyramid"``, ``"gather4"`` or ``"patch"``
    (module docstring; ``max_flow`` bounds the shifts and pyramid warps
    only). ``flow`` [B,H,W,2] holds (dx, dy) in pixels. Returns f32
    [B,H,W,C]; differentiable in ``img`` and ``flow``."""
    passes = {"shifts": _warp_axis, "pyramid": _warp_axis_pyramid}
    if impl not in passes and impl not in ("gather4", "patch"):
        raise ValueError(f"unknown warp_impl {impl!r}")
    _, h, w, _ = img.shape
    if h < 2 or w < 2:
        raise ValueError(f"backward_warp needs H, W >= 2, got {(h, w)}")
    flow = flow.float()
    if impl not in passes:
        return _warp_gather4(img.float(), flow)
    hx = passes[impl](img.float(), flow[..., 0], 2, max_flow)
    return passes[impl](hx, flow[..., 1], 1, max_flow)
