"""Batched PSNR (JAX ``ops/psnr.py``; the reference uses skimage's
``peak_signal_noise_ratio`` on uint8 with ``data_range=255``)."""

from __future__ import annotations

import torch


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """PSNR in dB on the inputs' device, in f32. [N,H,W,C] -> [N];
    [H,W,C] -> scalar."""
    squeeze = img1.ndim == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    x = img1.to(torch.float32)
    y = img2.to(torch.float32)
    mse = torch.mean((x - y) ** 2, dim=(1, 2, 3))
    out = 10.0 * torch.log10((data_range ** 2) / torch.clamp(mse, min=1e-12))
    return out[0] if squeeze else out
