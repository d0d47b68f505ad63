"""ADMM iterations a plan took, as the fused solve returns them, mean over the
traced run's plans after the profiled ones (layer: the step,
`solver/admm.py`, `solver/multi.py`)."""


def read(ctx):
    its = [a.iterations for a in ctx.timed]
    return sum(its) / len(its) if its else None
