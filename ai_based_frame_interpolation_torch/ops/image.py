"""Normalize uint8 frames to [-1, 1] and back, and read and write image
files (JAX ``ops/image.py``).

The JAX package decodes with OpenCV; the card's machine has none, so the
port reads and writes PNG through its own codec (``ops/png.py``) and
resizes with the same half-pixel bilinear grid as ``cv2.resize(...,
INTER_LINEAR)``, in f32 and then rounded (cv2 uses 11-bit fixed-point taps:
the two agree within 1 LSB).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .png import decode_png, encode_png, to_gray, to_rgb
from .resize import resize_bilinear


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


def _check_png(path: str) -> None:
    if os.path.splitext(path)[1].lower() != ".png":
        raise NotImplementedError(
            f"{path}: the port reads and writes PNG only; JPEG and BMP "
            "decoding without OpenCV waits for ROADMAP Queue A, serving "
            "and the CLI")


def resize_uint8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """HWC uint8 -> ``size`` (H, W) uint8 by half-pixel bilinear in f32,
    rounded: ``cv2.resize(INTER_LINEAR)`` within 1 LSB."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = resize_bilinear(x.float(), size, align_corners=False)
    y = torch.round(y).clamp(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def load_image(path: str, grayscale: bool = True,
               size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Read a PNG as HWC uint8 (C=1 gray as ``cv2.IMREAD_GRAYSCALE`` reads
    it, or C=3 RGB), resized to ``size`` (H, W) when given."""
    _check_png(path)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(f"could not read image: {path}") from e
    img = decode_png(data)
    img = to_gray(img) if grayscale else to_rgb(img)
    if size is not None and (img.shape[0], img.shape[1]) != tuple(size):
        img = resize_uint8(img, size)
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Write HWC uint8 (1 or 3 channels, RGB) as a PNG."""
    _check_png(path)
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img)))
