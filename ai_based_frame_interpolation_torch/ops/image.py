"""Normalize uint8 frames to [-1, 1] and back (JAX ``ops/image.py``)."""

from __future__ import annotations

import torch


def normalize_uint8(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> ``dtype`` [-1,1], bit-identical to the JAX version.

    JAX rounds the weakly typed scalar 2/255 to ``dtype`` before the
    multiply; a Python float here would stay f32 inside torch's bf16 kernel
    and differ by one bf16 ulp on 111 of the 256 inputs. So the scalar is
    made a ``dtype`` tensor first.
    """
    scale = torch.tensor(2.0 / 255.0, dtype=dtype, device=x.device)
    return x.to(dtype) * scale - 1.0


def denormalize_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] float -> uint8 [0,255]: clip, then round half to even (what
    ``jnp.round`` and ``torch.round`` both do)."""
    y = (x.float() + 1.0) * 0.5
    y = torch.clamp(y, 0.0, 1.0) * 255.0
    return torch.round(y).to(torch.uint8)
