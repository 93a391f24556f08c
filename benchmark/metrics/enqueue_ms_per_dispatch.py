"""Host ms a dispatch in the port's span ``engine.enqueue``: the host
issuing a dispatch's model work (the call of the engine's pair, time or
tower-stream function, with any host wait or table upload inside it).
The span's seconds over the traced window (the port's
``profiling.totals()``) over its ``engine.dispatches``; None without
either."""

from benchmark.harness.spans import ms_per_dispatch


def read(ctx):
    return ms_per_dispatch("engine.enqueue")
