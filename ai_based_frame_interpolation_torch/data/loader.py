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

With a process group's ``mesh`` every rank draws the same order and
decodes only its part of each global batch (``parallel.sharding.
shard_items``, in ``grad_accum``'s microbatch order), onto its card; the
ranks' parts of a batch put together are JAX's batch bit for bit, corrupt
files included. A last batch the ranks do not divide is padded to equal
parts and carries a ``valid`` mask, which validation reads.
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
from ..parallel.mesh import group_mesh
from ..parallel.sharding import shard_items
from .triplets import Triplet, load_triplet_arrays


class TripletLoader:
    """Iterable over epochs of batched triplet arrays.

    Yields dicts ``{"f0": [B,H,W,C] uint8, "f1": ..., "gt": ...}`` of
    tensors on ``device`` (the card unless ``"cpu"``); with a process
    group's ``mesh``, this rank's part of each batch on its card (module
    docstring) and ``"valid"`` where the part is padded. ``len`` counts
    global batches.
    """

    def __init__(self, triplets: Sequence[Triplet], batch_size: int,
                 height: int = 256, width: int = 256, grayscale: bool = True,
                 shuffle: bool = True, seed: int = 0, drop_remainder: bool = True,
                 num_workers: int = 4, device=None, prefetch: int = 2,
                 augment: bool = False, mesh=None, grad_accum: int = 1):
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
        self.mesh = mesh = group_mesh(mesh)
        self.grad_accum = grad_accum
        if mesh is not None:
            shard_items(batch_size, mesh, grad_accum)   # raises early
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
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

    def _decode(self, i: int):
        """Triplet ``i``'s arrays, or None where a file fails to decode
        (reported on stderr)."""
        try:
            return load_triplet_arrays(self.triplets[i], self.height,
                                       self.width, self.grayscale)
        except Exception as e:  # noqa: BLE001 — reported, then skipped
            print(f"warning: skipping triplet "
                  f"{self.triplets[i].paths()[0]}: {e}", file=sys.stderr)
            return None

    def _load_batch(self, idxs: np.ndarray) -> dict:
        """This process's items of the batch of triplets ``idxs``.

        One corrupt file must not end an epoch (the eval harness's policy),
        and the batch keeps its shape, as JAX's loader builds it: the
        leading items that fail are dropped, a later one repeats the item
        before it (augmented again as itself), and the end repeats the last
        item. So item p of the batch is the one built at position
        min(p + lead, B - 1), lead being the count of leading failures; a
        rank decodes its own positions, the first good one, and where one
        of its items fails, the items before it that the repeat needs."""
        n = len(idxs)
        if self.mesh is None:
            positions, n_valid = np.arange(n), n
        else:
            positions, n_valid = shard_items(n, self.mesh, self.grad_accum)
        decoded: dict = {}
        built: dict = {}

        def decode(q):
            if q not in decoded:
                decoded[q] = self._decode(int(idxs[q]))
            return decoded[q]

        def build(q):
            if q not in built:
                got = decode(q)
                if got is None:
                    got = build(q - 1)
                built[q] = self._augment_triplet(*got, int(idxs[q])) \
                    if self.augment else got
            return built[q]

        lead = 0
        while decode(lead) is None:
            lead += 1
            if lead == n:
                raise IOError("every triplet in the batch failed to decode")
        items = [build(min(int(p) + lead, n - 1)) for p in positions]
        batch = {k: torch.from_numpy(np.stack([it[j] for it in items]))
                 for j, k in enumerate(("f0", "f1", "gt"))}
        if n_valid < len(positions):
            batch["valid"] = torch.arange(len(positions)) < n_valid
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
