"""Profiling hooks on ``torch.profiler`` (JAX ``utils/profiling.py``).

``trace`` wraps a region in a profile written as a Chrome trace,
``annotate`` names a sub-region on its timeline, and
``device_memory_stats`` reads each card's allocator. The names and the
environment variable (``FI_TPU_PROFILE_DIR``) are the JAX package's.

Spans and counters. While a ``torch.profiler`` session runs (``trace``,
or a profiler the caller starts, as the benchmark's traced window does),
``annotate`` opens a ``record_function`` range, so the span lies on the
trace's timeline beside the device's work, and adds its seconds to a
table of totals by name; ``count`` adds to a named counter. ``totals``
and ``counters`` read the table, ``reset`` empties it; ``trace`` empties
it as its session starts, and a caller that starts its own sessions calls
``reset`` before each. With no profiler running, ``annotate`` and
``count`` cost one flag check each. The engine's (``infer/engine.py``),
once a dispatch: ``engine.upload``, ``engine.enqueue``,
``engine.download``, ``stream.interleave`` and the counter
``engine.dispatches``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional, Sequence

import torch

from .logging import StageTimer, get_logger

# torch's own flag for fast checks from Python: set for the whole process
# while any profiler session runs (the C++ check is per thread)
_PROFILER = torch.autograd.profiler
_OFF = contextlib.nullcontext()


class _Table:
    """The span totals and the counters recorded while a profiler ran."""

    def __init__(self):
        self.lock = threading.Lock()
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.timer = StageTimer()
            self.counters: Dict[str, int] = {}

    def add(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n


_TABLE = _Table()


class _Span(StageTimer._Ctx):
    """A span while it runs: a ``record_function`` range and a stage of the
    table's timer."""

    def __init__(self, name: str):
        super().__init__(_TABLE.timer, name)

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.range.__exit__(*exc)


def annotate(name: str):
    """A named span (module docstring): with a profiler running, a range on
    its timeline and its seconds in the table; else nothing but the flag
    check."""
    if not _PROFILER._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs (nothing but
    the flag check without one)."""
    if _PROFILER._is_profiler_enabled:
        _TABLE.add(name, n)


def totals() -> Dict[str, dict]:
    """By span name: ``count``, ``seconds`` and ``self_seconds`` (the
    seconds less those of the spans opened inside it on its thread)."""
    return _TABLE.timer.summary()


def counters() -> Dict[str, int]:
    with _TABLE.lock:
        return dict(_TABLE.counters)


def reset() -> None:
    """Empty the table of totals and counters."""
    _TABLE.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the region (CPU activity, and CUDA activity where a card is
    visible) into a Chrome trace ``trace_<pid>_<ns>.json`` in ``log_dir``
    (or ``FI_TPU_PROFILE_DIR``), and log the totals of the spans recorded
    in it (the table is emptied as it starts); a no-op when neither is
    set."""
    log_dir = log_dir or os.environ.get("FI_TPU_PROFILE_DIR")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log = get_logger()
    log.info("trace %s; spans:", path)
    _TABLE.timer.log_summary(log.info)


def device_memory_stats(devices: Optional[Sequence] = None) -> dict:
    """``torch.cuda.memory_stats`` of each of ``devices`` (every visible
    card by default), by device name; None for a device without them (the
    CPU). With no card and no ``devices`` it raises ``RuntimeError``:
    nothing reads the CPU unasked."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to "
                               "read the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = {}
    for d in map(torch.device, devices):
        out[str(d)] = torch.cuda.memory_stats(d) if d.type == "cuda" \
            else None
    return out
