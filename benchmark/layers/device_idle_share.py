"""The share of the traced plans' wall time in which no kernel, copy or
fill ran on the device, in % (layer: the device)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s > 0 else None
