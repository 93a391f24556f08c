"""Host ms a dispatch in the port's span ``engine.upload``: the host's
upload of a dispatch's inputs (the pair entries' pageable ``_put``; a
stream's stacking into its pinned buffer, the wait for that buffer and
the queued copy). The span's seconds over the traced window (the port's
``profiling.totals()``) over its ``engine.dispatches``; None without
either."""

from benchmark.harness.spans import ms_per_dispatch


def read(ctx):
    return ms_per_dispatch("engine.upload")
