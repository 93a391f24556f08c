"""Normalize uint8 frames to [-1, 1] and back, and read and write image
files (JAX ``ops/image.py``).

The JAX package decodes with OpenCV, which the card's machine need not
have, so the port reads and writes 8-bit PNG through its own codec
(``ops/png.py``) on every machine, and resizes with the same half-pixel
bilinear grid as ``cv2.resize(..., INTER_LINEAR)``, in f32 and then
rounded (cv2 uses 11-bit fixed-point taps: the two agree within 1 LSB).
What the codec does not read or write (palette, 16-bit and interlaced PNG;
JPEG, BMP, TIFF) goes through OpenCV where it is installed, as every image
does in the JAX package, and raises an ``ImportError`` that names OpenCV
where it is not (:func:`decode_image`, :func:`save_image`).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from .png import SIGNATURE, decode_png, encode_png, to_gray, to_rgb
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


def preprocess_frames(frames_u8: torch.Tensor,
                      out_hw: Optional[Tuple[int, int]] = None,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 NHWC frames -> ``dtype`` in [-1, 1], resized to ``out_hw``
    (H, W) on the half-pixel bilinear grid where given (JAX
    ``preprocess_frames``): normalized in f32, resized, then cast."""
    x = normalize_uint8(frames_u8, dtype=torch.float32)
    if out_hw is not None and tuple(out_hw) != tuple(x.shape[-3:-1]):
        x = resize_bilinear(x.permute(0, 3, 1, 2), out_hw,
                            align_corners=False).permute(0, 2, 3, 1)
    return x.to(dtype)


# JPEG, BMP and little- and big-endian TIFF
_OPENCV_MAGIC = (b"\xff\xd8\xff", b"BM", b"II*\x00", b"MM\x00*")


def _opencv(what: str):
    """The cv2 module, or an ``ImportError`` that names OpenCV for
    ``what``."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} go through OpenCV (the cv2 module), which is not "
            "installed; 8-bit PNG needs none. Codecs without OpenCV are on "
            "the ROADMAP's list of features the JAX package lacks") from e
    return cv2


def decode_image(data: bytes, grayscale: bool = True) -> np.ndarray:
    """Encoded image bytes -> HWC uint8, C=1 gray as
    ``cv2.IMREAD_GRAYSCALE`` reads it or C=3 RGB.

    8-bit PNG goes through the port's codec on every machine. Other PNGs
    (palette, 16-bit, interlaced) and other formats go to ``cv2.imdecode``
    where OpenCV is installed, which reads them as 8-bit, as the JAX
    package does; where it is not, they and JPEG, BMP and TIFF raise an
    ``ImportError`` that names it. Raises ``ValueError`` for bytes that are
    no image it can decode (where ``cv2.imdecode`` returns None).
    """
    if data[:8] == SIGNATURE:
        try:
            img = decode_png(data)
        except (ValueError, struct.error, zlib.error) as e:
            raise ValueError(f"could not decode image: {e}") from e
        except NotImplementedError:
            cv2 = _opencv("PNGs other than 8-bit gray, gray+alpha, RGB "
                          "and RGBA")
        else:
            return to_gray(img) if grayscale else to_rgb(img)
    elif bytes(data[:4]).startswith(_OPENCV_MAGIC):
        cv2 = _opencv("JPEG, BMP and TIFF images")
    else:
        try:
            cv2 = _opencv("images")
        except ImportError:
            raise ValueError("could not decode image") from None
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_GRAYSCALE if grayscale
                       else cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("could not decode image")
    return img[..., None] if img.ndim == 2 else img[..., ::-1].copy()


def resize_uint8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """HWC uint8 -> ``size`` (H, W) uint8 by half-pixel bilinear in f32,
    rounded: ``cv2.resize(INTER_LINEAR)`` within 1 LSB."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = resize_bilinear(x.float(), size, align_corners=False)
    y = torch.round(y).clamp(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def load_image(path: str, grayscale: bool = True,
               size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Read an image file as HWC uint8 (C=1 gray as
    ``cv2.IMREAD_GRAYSCALE`` reads it, or C=3 RGB) through
    :func:`decode_image`, resized to ``size`` (H, W) when given."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(f"could not read image: {path}") from e
    img = decode_image(data, grayscale)
    if size is not None and (img.shape[0], img.shape[1]) != tuple(size):
        img = resize_uint8(img, size)
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Write HWC uint8 (1 or 3 channels, RGB): a ``.png`` through the
    port's codec, any other extension through ``cv2.imwrite`` where OpenCV
    is installed (as the JAX package writes every image), an
    ``ImportError`` that names OpenCV where it is not. Raises ``IOError``
    where ``cv2.imwrite`` writes nothing."""
    img = np.asarray(img)
    if os.path.splitext(path)[1].lower() == ".png":
        with open(path, "wb") as f:
            f.write(encode_png(img))
        return
    cv2 = _opencv(f"images other than PNG ({path})")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[:, :, 0]
    elif img.ndim == 3 and img.shape[-1] == 3:
        img = img[:, :, ::-1]                       # RGB -> BGR
    if not cv2.imwrite(path, img):
        raise IOError(f"could not write image: {path}")
