"""The moving-circle fixture (JAX ``data/synthetic.py``), written through
the port's PNG encoder.

A white disc translating left to right with additive noise, as the
reference's ``demo_simple.py:17-40`` draws it, from a seeded numpy
generator, in the reference's layout ``<root>/<video>/frame_XXX.png``.
The JAX module's other generators wait for the training and video slices.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..ops.image import save_image


def moving_circle_frames(num_frames: int = 5, height: int = 256,
                         width: int = 256, radius: int = 30,
                         step: int = 40, noise: int = 10,
                         channels: int = 1, seed: int = 0) -> np.ndarray:
    """[T, H, W, C] uint8 frames of a bright disc translating left->right."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    frames = []
    for t in range(num_frames):
        cx = radius + 20 + t * step
        cy = height // 2
        disc = ((xx - cx) ** 2 + (yy - cy) ** 2) <= radius ** 2
        img = np.full((height, width), 40, np.float32)
        img[disc] = 230.0
        img = img + rng.uniform(-noise, noise, img.shape)
        frame = np.clip(img, 0, 255).astype(np.uint8)[..., None]
        if channels == 3:
            frame = np.repeat(frame, 3, axis=-1)
        frames.append(frame)
    return np.stack(frames)


def write_fixture_tree(root: str, num_videos: int = 1, num_frames: int = 5,
                       height: int = 256, width: int = 256,
                       channels: int = 1, seed: int = 0) -> List[str]:
    """Write ``<root>/video_XX/frame_XXX.png`` trees; returns video dirs."""
    dirs = []
    for v in range(num_videos):
        vdir = os.path.join(root, f"video_{v:02d}")
        os.makedirs(vdir, exist_ok=True)
        frames = moving_circle_frames(num_frames, height, width,
                                      channels=channels, seed=seed + v,
                                      step=max(8, 40 - 6 * v))
        for i, f in enumerate(frames):
            save_image(os.path.join(vdir, f"frame_{i:03d}.png"), f)
        dirs.append(vdir)
    return dirs
