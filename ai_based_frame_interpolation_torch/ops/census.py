"""Soft census-transform loss, plain PyTorch in f32 (JAX ``ops/census.py``).

The census transform encodes each pixel by the sign of its difference to
every neighbour in a window, so it is invariant to monotonic brightness
and gain changes (UnFlow, Meister et al. AAAI'18, eq. 5). A train-time
term of the loss (``LossConfig.census_weight``), off by default; the soft
sign and soft Hamming distance keep it differentiable. NHWC, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def census_transform(x: torch.Tensor, window: int = 7,
                     eps: float = 0.81) -> torch.Tensor:
    """Soft census descriptor per pixel: [B,H,W,C] -> [B,H,W,window**2-1].

    ``x`` in [-1, 1]; several channels are averaged to one first. Each
    component is ``d / sqrt(eps + d^2)`` of the neighbour difference ``d``
    at the [0, 255] intensity scale, the image edge-padded.
    """
    if window % 2 == 0 or window < 3:
        raise ValueError(f"census window must be odd >= 3, got {window}")
    x = x.to(torch.float32)
    if x.shape[-1] > 1:
        x = torch.mean(x, -1, keepdim=True)
    x = (x + 1.0) * 127.5
    p = window // 2
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate") \
        .permute(0, 2, 3, 1)
    comps = []
    for dy in range(window):
        for dx in range(window):
            if dy == p and dx == p:
                continue
            d = xp[:, dy:dy + h, dx:dx + w, :] - x
            comps.append(d * torch.rsqrt(eps + d * d))
    return torch.cat(comps, -1)


def census_loss(pred: torch.Tensor, gt: torch.Tensor,
                window: int = 7) -> torch.Tensor:
    """Mean soft Hamming distance between the census descriptors of
    ``pred`` and ``gt``, over the pixels whose window lies inside the
    image. A scalar in [0, 1)."""
    t1 = census_transform(pred, window)
    t2 = census_transform(gt, window)
    sq = (t1 - t2) ** 2
    ham = sq / (0.1 + sq)
    p = window // 2
    return torch.mean(ham[:, p:-p, p:-p, :])
