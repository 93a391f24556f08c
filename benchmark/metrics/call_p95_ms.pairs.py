"""The 95th percentile of the wall time of every ``interpolate_batch``
call in the traced window, on the host's clock."""

import statistics


def read(ctx):
    calls = ctx.record.get("call_ms")
    if not calls or len(calls) < 2:
        return None
    return statistics.quantiles(calls, n=20, method="inclusive")[-1]
