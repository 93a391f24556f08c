"""Seconds from the interpreter's start to the window's, on the host's
clock: imports, the card's start, weights and inputs, the engine, the
warm-up and, in a first run, the kernels' build."""


def read(ctx):
    return ctx.record["setup_s"]
