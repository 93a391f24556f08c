"""Structured logging and per-stage wall clocks (JAX
``utils/logging.py``): the same names and the same environment variable
(``FI_TPU_LOGLEVEL``)."""

from __future__ import annotations

import logging
import os
import sys
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
        timer.summary()  # {'decode': {'seconds': ..., 'count': ...}, ...}

    The host's clock: work queued on a card inside a stage is counted only
    as far as the stage waits for it."""

    def __init__(self):
        self.totals: dict = {}

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer = timer
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            entry = self.timer.totals.setdefault(self.name,
                                                 {"seconds": 0.0, "count": 0})
            entry["seconds"] += dt
            entry["count"] += 1

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    def summary(self) -> dict:
        return {k: dict(v) for k, v in self.totals.items()}

    def log_summary(self, log_fn=print) -> None:
        """One line per stage, the longest first, with its share."""
        total = sum(v["seconds"] for v in self.totals.values()) or 1e-9
        for name, v in sorted(self.totals.items(),
                              key=lambda kv: -kv[1]["seconds"]):
            log_fn(f"  {name:12s} {v['seconds']:8.3f}s "
                   f"({100 * v['seconds'] / total:5.1f}%)  x{v['count']}")
