"""Host ms a dispatch in the port's span ``stream.interleave``: a stream
batch's playback-order assembly on the host (``native.interleave``). The
span's seconds over the traced window (the port's
``profiling.totals()``) over its ``engine.dispatches``; None without
either."""

from benchmark.harness.spans import ms_per_dispatch


def read(ctx):
    return ms_per_dispatch("stream.interleave")
