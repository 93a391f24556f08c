"""The eval harness's host-side baselines (JAX ``ops/flow.py``): the
linear blend, and OpenCV's Farneback flow with a half-step warp.

``cv2`` is imported inside :func:`farneback_midpoint` only: the card's
machine has no OpenCV, so the ``optical_flow`` method runs where OpenCV
is installed and not on the card (ROADMAP Queue A item 13).
"""

from __future__ import annotations

import numpy as np

FARNEBACK_PARAMS = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                        poly_n=5, poly_sigma=1.1, flags=0)


def farneback_midpoint(f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
    """Midpoint estimate by warping f1 halfway along the dense flow f1->f2.

    Inputs/outputs are HWC uint8 (C=1 grayscale; RGB inputs are flowed on
    luma and each channel warped with the same field). Samples f1 at
    ``x - 0.5*flow``, the correct sign (the reference's ``+`` moves content
    against the motion).
    """
    import cv2

    f1 = np.asarray(f1)
    f2 = np.asarray(f2)
    g1 = f1[..., 0] if f1.shape[-1] == 1 else cv2.cvtColor(f1, cv2.COLOR_RGB2GRAY)
    g2 = f2[..., 0] if f2.shape[-1] == 1 else cv2.cvtColor(f2, cv2.COLOR_RGB2GRAY)
    flow = cv2.calcOpticalFlowFarneback(g1, g2, None, **FARNEBACK_PARAMS)
    h, w = g1.shape
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    map_x = (gx - 0.5 * flow[..., 0]).astype(np.float32)
    map_y = (gy - 0.5 * flow[..., 1]).astype(np.float32)
    if f1.shape[-1] == 1:
        mid = cv2.remap(g1, map_x, map_y, cv2.INTER_LINEAR,
                        borderMode=cv2.BORDER_REPLICATE)[..., None]
    else:
        mid = cv2.remap(f1, map_x, map_y, cv2.INTER_LINEAR,
                        borderMode=cv2.BORDER_REPLICATE)
    return mid


def linear_midpoint(f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
    """Pixel-average baseline (reference ``evaluation_simple.py:71-74``)."""
    return ((f1.astype(np.float32) + f2.astype(np.float32)) / 2.0).astype(np.uint8)
