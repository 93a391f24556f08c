"""The port's own spans and counters (``utils/profiling.py`` of
``ai_based_frame_interpolation_torch``), as the traced window left them.

The harness starts the profiler at the window and stops it after, so the
port's table holds the window's spans alone. A program without the table
(one from before the spans), or a run without the span or the counter,
reads None.
"""

from __future__ import annotations

from typing import Optional

DISPATCHES = "engine.dispatches"


def ms_per_dispatch(span: str) -> Optional[float]:
    """Host ms that the span ``span`` took over the window, a dispatch
    (``engine.dispatches``); None where either is absent."""
    from ai_based_frame_interpolation_torch.utils import profiling

    totals = getattr(profiling, "totals", None)
    counters = getattr(profiling, "counters", None)
    if totals is None or counters is None:
        return None
    entry = totals().get(span)
    n = counters().get(DISPATCHES)
    if not entry or not n:
        return None
    return entry["seconds"] * 1e3 / n
