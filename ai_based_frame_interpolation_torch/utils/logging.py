"""Structured logging and per-stage wall clocks (JAX
``utils/logging.py``): the same names and the same environment variable
(``FI_TPU_LOGLEVEL``)."""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def get_logger(name: str = "fi_tpu", level: Optional[str] = None
               ) -> logging.Logger:
    """The logger ``name``, given a stderr handler and its level
    (``level``, else ``FI_TPU_LOGLEVEL``, else INFO) the first time."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level or os.environ.get("FI_TPU_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger


class StageTimer:
    """Per-stage wall-clock totals, e.g. of a video pipeline's decode,
    upload, step and encode::

        timer = StageTimer()
        with timer.stage("decode"):
            ...
        timer.summary()
        # {'decode': {'seconds': ..., 'count': ..., 'self_seconds': ...}}

    A stage's self seconds are its seconds less those of the stages opened
    inside it on the same thread. The host's clock: work queued on a card
    inside a stage is counted only as far as the stage waits for it. The
    port's spans (``utils/profiling.py``) keep their totals in one of
    these."""

    def __init__(self):
        self.totals: dict = {}
        self._lock = threading.Lock()
        self._open = threading.local()

    class _Ctx:
        """One stage while it runs: ``parent`` is the stage open around it
        on its thread."""

        def __init__(self, timer: "StageTimer", name: str):
            self.timer = timer
            self.name = name

        def __enter__(self):
            stack = self.timer._stack()
            self.parent = stack[-1] if stack else None
            self.inner_ns = 0
            stack.append(self)
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            took = time.perf_counter_ns() - self.t0
            self.timer._stack().pop()
            if self.parent is not None:
                self.parent.inner_ns += took
            with self.timer._lock:
                entry = self.timer.totals.setdefault(
                    self.name,
                    {"seconds": 0.0, "count": 0, "self_seconds": 0.0})
                entry["seconds"] += took * 1e-9
                entry["self_seconds"] += (took - self.inner_ns) * 1e-9
                entry["count"] += 1

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    def summary(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self.totals.items()}

    def log_summary(self, log_fn=print) -> None:
        """One line per stage, the longest first, with its share of the
        stages' self seconds and its own."""
        totals = self.summary()
        total = sum(v["self_seconds"] for v in totals.values()) or 1e-9
        for name, v in sorted(totals.items(),
                              key=lambda kv: -kv[1]["seconds"]):
            log_fn(f"  {name:12s} {v['seconds']:8.3f}s "
                   f"(self {v['self_seconds']:.3f}s, "
                   f"{100 * v['self_seconds'] / total:5.1f}%)  "
                   f"x{v['count']}")
