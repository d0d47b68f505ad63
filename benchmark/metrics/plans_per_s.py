"""Plans completed per second: every answer of the window over the
window's length (host clock, the window closing at the end of the first
plan that ends past ``--seconds``)."""


def read(ctx):
    return len(ctx.answers) / ctx.window_s if ctx.answers else None
