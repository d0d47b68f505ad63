"""What a plan costs outside its graph launch: its latency less
`FusedRun.replay_ms`, mean over the plans after the profiled ones (layer:
the drivers and inputs, `solver/driver.py`, `runtime/cache.py`,
`types.py`)."""


def read(ctx):
    rows = [a.latency_ms - a.launch_ms for a in ctx.timed]
    return sum(rows) / len(rows) if rows else None
