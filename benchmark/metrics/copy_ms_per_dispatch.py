"""Device time of the host-to-device and device-to-host copies a
dispatch (an ``interpolate_batch`` call, or a stream's batch of pairs), in
the trace."""

from benchmark.harness.trace import kernel_time


def read(ctx):
    n, secs = kernel_time(ctx.trace, "Memcpy HtoD", "Memcpy DtoH")
    if not n or not ctx.record.get("dispatches"):
        return None
    return secs * 1e3 / ctx.record["dispatches"]
