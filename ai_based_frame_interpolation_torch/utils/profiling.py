"""Profiling hooks on ``torch.profiler`` (JAX ``utils/profiling.py``).

``trace`` wraps a region in a profile written as a Chrome trace,
``annotate`` names a sub-region on its timeline, and
``device_memory_stats`` reads each card's allocator. The names and the
environment variable (``FI_TPU_PROFILE_DIR``) are the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Sequence

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the region (CPU activity, and CUDA activity where a card is
    visible) into a Chrome trace ``trace_<pid>_<ns>.json`` in ``log_dir``
    (or ``FI_TPU_PROFILE_DIR``); a no-op when neither is set."""
    log_dir = log_dir or os.environ.get("FI_TPU_PROFILE_DIR")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region on the profiler's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


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
