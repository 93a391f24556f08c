"""Host ms a dispatch in the port's span ``engine.download``: the host
blocked until a dispatch's output is on the host (the wait for the card
and the copy: ``.cpu()``, or a stream's ``_Transfers.download``). The
span's seconds over the traced window (the port's
``profiling.totals()``) over its ``engine.dispatches``; None without
either."""

from benchmark.harness.spans import ms_per_dispatch


def read(ctx):
    return ms_per_dispatch("engine.download")
