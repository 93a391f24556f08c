"""The traced window: ``torch.profiler`` over the device and the host, and
its reduction to what the per-layer metrics read.

The window is the span ``bench.window`` that the harness opens around its
loop (which ends with a device synchronise). Every device activity
(kernels, copies, sets) inside it counts as busy time, overlaps merged;
the rest of the window is idle. Each idle gap is named by the innermost
host event running at its middle: a torch operation or CUDA runtime call,
or one of the harness's own spans (``bench.call``, ``bench.next_frame``,
``bench.keep``) where the host runs Python between operations.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "bench.window"
TOP = 10
# the profiler's own host events, which say nothing of the program
PROFILER_OWN = ("Activity Buffer Request",)


def profiler():
    """A profiler of the host and the card, not yet started."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:120]
    name = name.replace("(anonymous namespace)::", "")
    found = re.match(r"(?:void )?([A-Za-z_][\w:]*)", name)
    short = found.group(1) if found else name
    return short[:120]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(prof) -> Optional[dict]:
    """The window's device time by kernel, its busy and idle time, the
    copies and collectives, and its longest idle gaps; None if the
    profiler recorded no device activity in it."""
    events = prof.profiler.kineto_results.events()
    host, device = [], []
    window = None
    for ev in events:
        start, end = ev.start_ns(), ev.end_ns()
        if str(ev.device_type()).endswith("CPU"):
            if ev.name() == WINDOW:
                window = (start, end)
            elif ev.name() not in PROFILER_OWN:
                host.append((start, end, ev.name()))
        else:
            device.append((start, end, ev.name()))
    # host spans mirrored onto the device's timeline (the window's, the
    # collectives' record_function ranges) are no device work
    spans = {h[2] for h in host} | {WINDOW}
    device = [d for d in device if d[2] not in spans]
    if window is None or not device:
        return None
    lo, hi = window
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device
              if b > lo and a < hi]
    if not inside:
        return None
    kernels: Dict[str, List[float]] = {}
    for a, b, n in inside:
        k = kernels.setdefault(_short(n), [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-9
    busy = _union([(a, b) for a, b, _ in inside])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = np.array([h[0] for h in host], np.int64)
    ends = np.array([h[1] for h in host], np.int64)
    named = []
    for a, b in gaps[:TOP]:
        mid = (a + b) // 2
        # the latest-starting host event that still runs at the middle
        running = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = host[running[np.argmax(starts[running])]][2] \
            if running.size else "no host event"
        named.append([name[:120], (b - a) * 1e-9])
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy_s,
        "kernels": kernels,
        "device_ops": sorted(([n, v[1]] for n, v in kernels.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": named,
    }


def kernel_time(summary: dict, *parts: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds one of
    ``parts`` (any case)."""
    n, s = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if any(p.lower() in name.lower() for p in parts):
            n += count
            s += secs
    return n, s
