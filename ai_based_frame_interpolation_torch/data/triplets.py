"""Frame-triplet index and deterministic splits (JAX ``data/triplets.py``).

Walks ``data_dir/<video>/frame_*.{jpg,png,bmp}`` sorted and forms triplets
``(frame_i, frame_{i+2}) -> frame_{i+1}``, as the reference dataset does
(``model/train.py:89-151``). The index lists every image extension; the
port decodes PNG only (``ops/image.py``), so a triplet of another format
fails when it is loaded, and the eval harness skips it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


@dataclass(frozen=True)
class Triplet:
    video_dir: str
    frame_t0: str
    frame_t1: str        # the *later* input frame (i+2)
    ground_truth: str    # the midpoint target (i+1)
    video_name: str = ""
    triplet_id: int = 0

    def paths(self) -> Tuple[str, str, str]:
        j = os.path.join
        return (j(self.video_dir, self.frame_t0),
                j(self.video_dir, self.frame_t1),
                j(self.video_dir, self.ground_truth))


def scan_triplets(data_dir: str) -> List[Triplet]:
    """Walk the reference's directory layout into a triplet index."""
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(f"data dir not found: {data_dir}")
    triplets: List[Triplet] = []
    for video in sorted(os.listdir(data_dir)):
        vdir = os.path.join(data_dir, video)
        if not os.path.isdir(vdir):
            continue
        frames = sorted(f for f in os.listdir(vdir)
                        if f.lower().endswith(IMAGE_EXTS))
        for i in range(len(frames) - 2):
            triplets.append(Triplet(video_dir=vdir, frame_t0=frames[i],
                                    frame_t1=frames[i + 2],
                                    ground_truth=frames[i + 1],
                                    video_name=video, triplet_id=i))
    return triplets


def split_triplets(triplets: Sequence[Triplet], val_split: float = 0.2,
                   seed: int = 0) -> Tuple[List[Triplet], List[Triplet]]:
    """Deterministic shuffled train/val split (the reference's 80/20
    ``random_split``, seeded)."""
    idx = np.random.default_rng(seed).permutation(len(triplets))
    n_val = int(round(len(triplets) * val_split))
    val = [triplets[i] for i in idx[:n_val]]
    train = [triplets[i] for i in idx[n_val:]]
    return train, val


def load_triplet_arrays(t: Triplet, height: int = 256, width: int = 256,
                        grayscale: bool = True) -> Tuple[np.ndarray, ...]:
    """Decode one triplet to three HWC uint8 arrays (host side)."""
    from ..ops.image import load_image

    return tuple(load_image(p, grayscale=grayscale, size=(height, width))
                 for p in t.paths())
