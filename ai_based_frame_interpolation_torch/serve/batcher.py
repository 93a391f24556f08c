"""Continuous request batching over the port's engine (JAX package
``serve/batcher.py``, the same contract).

- Arriving requests enqueue; the first becomes the dispatcher and takes
  every pending request with the same ``num_intermediate`` (bisection depth
  and output count must match) up to ``max_batch``, in ONE batched call.
- Requests that arrive while the card is busy accumulate; whichever is
  still pending when it frees dispatches the whole group. A lone request
  waits for nothing, and under load the batch grows with the arrival rate.
- Batches are padded up to a bucket size (1/2/4/8 by default) by repeating
  the last pair, so the engine sees a few batch shapes only.
- ``window_ms`` adds an optional straggler wait before each dispatch.
- ``stats`` adds to JAX's the mean wait from a request's arrival to the
  start of its group's batched call (``avg_queue_wait_ms``); the batched
  call is one engine dispatch (``infer.engine.dispatch``), in the
  engine's spans.

One difference: the leading request forms the group as in JAX's design,
but the batched call runs on one thread of the batcher's own (started at
the first request), and :meth:`DynamicBatcher.call` runs other device work
there too. The HTTP server answers each connection on a new thread, and a
thread's first PyTorch work on the card costs tens of milliseconds
(``PERF.md``, PR 13: 65 ms against 8 ms for the same request).
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..infer.engine import dispatch


class _Item:
    __slots__ = ("f1", "f2", "num", "result", "error", "done", "arrived")

    def __init__(self, f1: np.ndarray, f2: np.ndarray, num: int):
        self.f1 = f1
        self.f2 = f2
        self.num = num
        self.result: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.done = False
        self.arrived = time.perf_counter()


class DynamicBatcher:
    """Coalesces concurrent midpoint requests into batched engine calls.

    engine : the port's ``InterpolationEngine`` (its ``_pair_fn`` takes
        ``[B, H, W, C]`` uint8 tensors and returns ``[B, n, H, W, C]``)
    max_batch : upper bound on requests fused into one call (clamped to
        the largest bucket)
    buckets : batch sizes that reach the engine, ascending
    window_ms : straggler wait before each dispatch (0 = none)
    """

    def __init__(self, engine, max_batch: int = 8,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 window_ms: float = 0.0):
        self.engine = engine
        self.buckets = tuple(sorted(buckets))
        self.max_batch = min(max_batch, self.buckets[-1])
        self.window_ms = window_ms
        self._cond = threading.Condition()
        self._pending: List[_Item] = []
        self._dispatching = False
        # the one thread that reaches the card (module docstring)
        self._device = ThreadPoolExecutor(1, thread_name_prefix="batcher")
        self.dispatches = 0
        self.batched_requests = 0
        self.max_seen_batch = 0
        self.queue_wait_s = 0.0         # summed over the requests batched

    def generate_intermediate_frames(self, f1: np.ndarray, f2: np.ndarray,
                                     num: int) -> List[np.ndarray]:
        """``num`` in-between HWC uint8 frames in time order, as
        ``engine.generate_intermediate_frames``."""
        if num < 1:
            raise ValueError("num must be >= 1")
        item = _Item(f1, f2, num)
        with self._cond:
            self._pending.append(item)
            while not item.done:
                if not self._dispatching:
                    self._dispatch_locked(item)
                else:
                    self._cond.wait(timeout=0.1)
        if item.error is not None:
            raise item.error
        return item.result

    def interpolate_pair(self, f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
        """Batching-aware midpoint (``num=1``)."""
        return self.generate_intermediate_frames(f1, f2, 1)[0]

    def call(self, fn, *args):
        """``fn(*args)`` on the batcher's device thread, between batched
        calls (device work that is not a batched midpoint request)."""
        return self._device.submit(fn, *args).result()

    def close(self) -> None:
        """Stop the device thread once its queued work is done; later
        requests raise ``RuntimeError``."""
        self._device.shutdown(wait=True)

    def _dispatch_locked(self, leader: _Item) -> None:
        """With the lock held and ``leader`` pending: become the
        dispatcher, run one batched call, publish the results."""
        self._dispatching = True
        if self.window_ms > 0:
            self._cond.wait(timeout=self.window_ms / 1e3)
        # the oldest requests of the leader's num, which need not include
        # the leader: with more than max_batch of them pending it waits for
        # a later group (JAX's batcher returned here without dispatching,
        # and every later leader did the same: a spin holding the lock)
        group = [it for it in self._pending
                 if it.num == leader.num][:self.max_batch]
        if not group:                  # served during the straggler window
            self._dispatching = False
            self._cond.notify_all()
            return
        for it in group:
            self._pending.remove(it)
        self._cond.release()
        try:
            self.call(self._run_batch, group)
        except RuntimeError as e:        # closed: no device thread
            for it in group:
                it.error = e
        finally:
            self._cond.acquire()
            self._dispatching = False
            for it in group:
                it.done = True
            self._cond.notify_all()

    def _run_batch(self, group: List[_Item]) -> None:
        num = group[0].num
        n = len(group)
        now = time.perf_counter()
        self.queue_wait_s += sum(now - it.arrived for it in group)
        padded = next(b for b in self.buckets if b >= n)
        f1 = np.stack([it.f1 for it in group] + [group[-1].f1] * (padded - n))
        f2 = np.stack([it.f2 for it in group] + [group[-1].f2] * (padded - n))
        try:
            depth = max(1, math.ceil(math.log2(num + 1)))
            out = dispatch(self.engine, self.engine._pair_fn(num, depth),
                           (f1, f2))
            for b, it in enumerate(group):
                it.result = [out[b, i] for i in range(num)]
        except BaseException as e:  # noqa: BLE001 — delivered to every waiter
            for it in group:
                it.error = e
        self.dispatches += 1
        self.batched_requests += n
        self.max_seen_batch = max(self.max_seen_batch, n)

    @property
    def stats(self) -> dict:
        return {"dispatches": self.dispatches,
                "batched_requests": self.batched_requests,
                "max_batch_seen": self.max_seen_batch,
                "avg_batch": round(self.batched_requests /
                                   self.dispatches, 2)
                if self.dispatches else None,
                "avg_queue_wait_ms": round(1e3 * self.queue_wait_s /
                                           self.batched_requests, 3)
                if self.batched_requests else None}
