"""The frames the caller received over the window's seconds, on the
host's clock: a pair cell's in-betweens, every frame of a stream's
output."""


def read(ctx):
    return ctx.record["answers"] / ctx.record["window_s"]
