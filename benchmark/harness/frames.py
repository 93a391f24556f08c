"""The traffic's frames: seeded textures with motion, made on the device
and handed to the caller in host memory.

A texture is a sum of smooth random octaves (periods of 256, 64, 16 and 4
pixels, bilinear) plus a little pixel noise, each frame's mean and spread
set alike (grey level 127.5, 56) and clipped to 16 to 239. A pair is two
crops of one texture, the second moved by a random whole-pixel motion of
at most ``motion_px`` on each axis; a clip is crops of one texture
along a random path whose step is at most ``motion_px`` a frame. Every
seed makes frames of the same sizes; only their content changes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

OCTAVES = ((256, 1.0), (64, 0.6), (16, 0.35), (4, 0.2))
NOISE = 0.05


def _textures(gen, n: int, h: int, w: int, c: int, device) -> torch.Tensor:
    """[n, c, h, w] float32 in about [-1, 1]."""
    out = torch.zeros(n, c, h, w, device=device)
    for period, amp in OCTAVES:
        coarse = torch.randn(n, c, h // period + 2, w // period + 2,
                             generator=gen, device=device)
        up = F.interpolate(coarse, size=(h + 2 * period, w + 2 * period),
                           mode="bilinear", align_corners=False)
        out += amp * up[..., period:period + h, period:period + w]
    out += NOISE * torch.randn(n, c, h, w, generator=gen, device=device)
    out -= out.mean((1, 2, 3), keepdim=True)
    return out / out.std((1, 2, 3), keepdim=True)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """float [.., c, h, w] -> uint8 [.., h, w, c] in 16..239."""
    y = torch.clamp(127.5 + 56.0 * x, 16.0, 239.0).round().to(torch.uint8)
    return y.movedim(-3, -1).contiguous()


def pairs(seed: int, n: int, h: int, w: int, c: int, motion: int,
          device) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` independent pairs, uint8 [n, h, w, c] each, in host memory."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f1 = np.empty((n, h, w, c), np.uint8)
    f2 = np.empty((n, h, w, c), np.uint8)
    m = motion
    for i in range(0, n, 8):
        k = min(8, n - i)
        tex = _textures(gen, k, h + 2 * m, w + 2 * m, c, device)
        d = torch.randint(-m, m + 1, (k, 2), generator=gen, device=device)
        d = d.cpu().tolist()
        f1[i:i + k] = _to_u8(tex[..., m:m + h, m:m + w]).cpu().numpy()
        for j, (dy, dx) in enumerate(d):
            f2[i + j] = _to_u8(
                tex[j, :, m + dy:m + dy + h, m + dx:m + dx + w]).cpu().numpy()
    return f1, f2


def clip(seed: int, n: int, h: int, w: int, c: int, motion: int,
         device) -> np.ndarray:
    """``n`` consecutive frames of one moving texture, uint8 [n, h, w, c]:
    the crop window walks with a step of at most ``motion`` a frame on each
    axis, turning back at the texture's edge."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    margin = motion * n // 2 + 1
    tex = _textures(gen, 1, h + 2 * margin, w + 2 * margin, c, device)[0]
    steps = torch.randint(-motion, motion + 1, (n, 2), generator=gen,
                          device=device).cpu().tolist()
    y = x = margin
    out = np.empty((n, h, w, c), np.uint8)
    for i, (dy, dx) in enumerate(steps):
        out[i] = _to_u8(tex[:, y:y + h, x:x + w]).cpu().numpy()
        y = min(max(y + dy, 0), 2 * margin)
        x = min(max(x + dx, 0), 2 * margin)
    return out

