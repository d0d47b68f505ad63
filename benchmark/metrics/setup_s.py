"""Seconds from the process's start to the first timed request: imports,
the kernels' build or load, the request pool, the warm-up solves."""


def read(ctx):
    return ctx.setup_s
