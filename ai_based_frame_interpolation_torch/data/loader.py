"""Host input pipeline: threaded decode, batched uint8, bounded prefetch
(JAX ``data/loader.py``).

The counterpart of the reference's ``DataLoader(num_workers=4,
pin_memory=True)`` (``model/train.py:282-296``) and of the JAX package's
loader: PNG decode in a thread pool (``ops/png.py``; zlib and the host C
unfilter release the GIL), batches as **uint8** (a quarter of f32's
host-to-device bytes; the trainer normalizes on the device), a background
queue that keeps at most ``prefetch`` batches ready. On the card each
batch goes through pinned memory and a non-blocking copy. For the same
``seed`` the batches are the JAX loader's, in the same order.
"""

from __future__ import annotations

import queue
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np
import torch

from ..infer.engine import resolve_device
from .triplets import Triplet, load_triplet_arrays


class TripletLoader:
    """Iterable over epochs of batched triplet arrays.

    Yields dicts ``{"f0": [B,H,W,C] uint8, "f1": ..., "gt": ...}`` of
    tensors on ``device`` (the card unless ``"cpu"``).
    """

    def __init__(self, triplets: Sequence[Triplet], batch_size: int,
                 height: int = 256, width: int = 256, grayscale: bool = True,
                 shuffle: bool = True, seed: int = 0, drop_remainder: bool = True,
                 num_workers: int = 4, device=None, prefetch: int = 2,
                 augment: bool = False):
        if not triplets:
            raise ValueError("no triplets to load")
        self.triplets = list(triplets)
        self.batch_size = batch_size
        self.height, self.width = height, width
        self.grayscale = grayscale
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        # 0 = decode in one worker thread (ThreadPoolExecutor rejects 0)
        self.num_workers = max(1, num_workers)
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.augment = augment
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.triplets)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Make the next iteration epoch ``epoch`` (its order and
        augmentation); iterations count up from there."""
        self._epoch = epoch

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.triplets))
        rng = np.random.default_rng(self.seed + self._epoch)
        return rng.permutation(len(self.triplets))

    def _augment_triplet(self, f0, f1, gt, idx: int):
        """Label-consistent augmentation: flips apply to all three frames
        alike, and swapping f0 and f1 leaves the midpoint unchanged.
        Deterministic per (seed, epoch, item)."""
        rng = np.random.default_rng([self.seed, self._epoch, idx])
        hflip, vflip, tswap = rng.random(3) < 0.5
        if hflip:
            f0, f1, gt = (np.flip(a, axis=1) for a in (f0, f1, gt))
        if vflip:
            f0, f1, gt = (np.flip(a, axis=0) for a in (f0, f1, gt))
        if tswap:
            f0, f1 = f1, f0
        return np.ascontiguousarray(f0), np.ascontiguousarray(f1), \
            np.ascontiguousarray(gt)

    def _load_batch(self, idxs: np.ndarray) -> dict:
        f0s, f1s, gts = [], [], []
        for i in idxs:
            try:
                f0, f1, gt = load_triplet_arrays(
                    self.triplets[i], self.height, self.width, self.grayscale)
            except Exception as e:  # noqa: BLE001 — reported, then skipped
                # one corrupt file must not end an epoch (the eval
                # harness's policy): keep the batch shape by repeating the
                # previous good item
                print(f"warning: skipping triplet "
                      f"{self.triplets[i].paths()[0]}: {e}", file=sys.stderr)
                if not f0s:
                    continue
                f0, f1, gt = f0s[-1], f1s[-1], gts[-1]
            if self.augment:
                f0, f1, gt = self._augment_triplet(f0, f1, gt, int(i))
            f0s.append(f0); f1s.append(f1); gts.append(gt)
        if not f0s:
            raise IOError("every triplet in the batch failed to decode")
        while len(f0s) < len(idxs):   # keep the batch shape
            f0s.append(f0s[-1]); f1s.append(f1s[-1]); gts.append(gts[-1])
        batch = {k: torch.from_numpy(np.stack(v))
                 for k, v in (("f0", f0s), ("f1", f1s), ("gt", gts))}
        if self.device.type == "cuda":
            batch = {k: v.pin_memory().to(self.device, non_blocking=True)
                     for k, v in batch.items()}
        return batch

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        self._epoch += 1
        nfull = len(order) // self.batch_size
        chunks = [order[b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(nfull)]
        if not self.drop_remainder and len(order) % self.batch_size:
            chunks.append(order[nfull * self.batch_size:])

        q: "queue.Queue" = queue.Queue(self.prefetch)
        err: List[BaseException] = []

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # bounded in-flight decode: q.put blocks while the
                    # consumer lags
                    pending = deque()
                    max_inflight = max(self.prefetch, self.num_workers)
                    for c in chunks:
                        pending.append(pool.submit(self._load_batch, c))
                        if len(pending) >= max_inflight:
                            q.put(pending.popleft().result())
                    while pending:
                        q.put(pending.popleft().result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
        t.join()
        if err:
            raise err[0]
