"""Host helpers of the video stream (JAX ``ops/native``).

Each helper runs ``csrc/fastimage.c`` (host C, built at first use by
``ops/_build.py``, called through ``ctypes``) on C-contiguous uint8 numpy
arrays; only :func:`interleave` is on the video path. There is no numpy
fallback: if the library cannot be built, the call raises. Beside each
helper, ``*_reference`` is the same function in numpy (the JAX module's
fallback arithmetic), for the tests.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import _build

_ARGTYPES = {
    "bgr_to_gray_u8": [ctypes.c_void_p] * 2 + [ctypes.c_int64],
    "bgr_to_rgb_u8": [ctypes.c_void_p] * 2 + [ctypes.c_int64],
    "pack_pairs_u8": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2,
    "interleave_u8": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3,
}


def _fn(name: str):
    fn = getattr(_build.load("fastimage"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = None
    return fn


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint8)


def _check_bgr(bgr: np.ndarray) -> None:
    if bgr.ndim < 1 or bgr.shape[-1] != 3:
        raise ValueError(f"expected [..., 3] BGR pixels, got {bgr.shape}")


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] uint8 BGR -> [..., H, W, 1] uint8 BT.601 luma."""
    bgr = _u8(bgr)
    _check_bgr(bgr)
    out = np.empty(bgr.shape[:-1], np.uint8)
    _fn("bgr_to_gray_u8")(bgr.ctypes.data, out.ctypes.data, out.size)
    return out[..., None]


def bgr_to_gray_reference(bgr: np.ndarray) -> np.ndarray:
    b, g, r = (bgr[..., i].astype(np.uint32) for i in range(3))
    return ((77 * r + 150 * g + 29 * b + 128) >> 8).astype(np.uint8)[..., None]


def bgr_to_rgb(bgr: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 BGR -> RGB (a new array)."""
    bgr = _u8(bgr)
    _check_bgr(bgr)
    out = np.empty_like(bgr)
    _fn("bgr_to_rgb_u8")(bgr.ctypes.data, out.ctypes.data, bgr.size // 3)
    return out


def bgr_to_rgb_reference(bgr: np.ndarray) -> np.ndarray:
    return bgr[..., ::-1].copy()


def pack_pairs(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, H, W, C] u8 -> ([N-1, ...] f_i, [N-1, ...] f_{i+1}), contiguous."""
    frames = _u8(frames)
    n = frames.shape[0]
    if n < 2:
        raise ValueError("need at least 2 frames")
    out1 = np.empty((n - 1, *frames.shape[1:]), np.uint8)
    out2 = np.empty_like(out1)
    _fn("pack_pairs_u8")(frames.ctypes.data, out1.ctypes.data,
                         out2.ctypes.data, n, frames[0].size)
    return out1, out2


def pack_pairs_reference(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return frames[:-1].copy(), frames[1:].copy()


def _check_interleave(originals: np.ndarray, mids: np.ndarray) -> None:
    if mids.ndim < 2 or originals.shape[0] != mids.shape[0] + 1:
        raise ValueError(f"need {mids.shape[0] + 1} originals for "
                         f"{mids.shape[0]} pairs, got {originals.shape[0]}")
    if originals.shape[1:] != mids.shape[2:]:
        raise ValueError("frame shape mismatch")


def interleave(originals: np.ndarray, mids: np.ndarray) -> np.ndarray:
    """originals [P+1, H, W, C] + mids [P, K, H, W, C] -> [P*(K+1)+1, ...]
    in playback order (the 2x/4x output-stream assembly)."""
    originals, mids = _u8(originals), _u8(mids)
    _check_interleave(originals, mids)
    p, k = mids.shape[:2]
    out = np.empty((p * (k + 1) + 1, *originals.shape[1:]), np.uint8)
    _fn("interleave_u8")(originals.ctypes.data, mids.ctypes.data,
                         out.ctypes.data, p, k, originals[0].size)
    return out


def interleave_reference(originals: np.ndarray, mids: np.ndarray
                         ) -> np.ndarray:
    _check_interleave(originals, mids)
    p, k = mids.shape[:2]
    out = np.empty((p * (k + 1) + 1, *originals.shape[1:]), np.uint8)
    for i in range(p):
        out[i * (k + 1)] = originals[i]
        out[i * (k + 1) + 1:(i + 1) * (k + 1)] = mids[i]
    out[-1] = originals[-1]
    return out
