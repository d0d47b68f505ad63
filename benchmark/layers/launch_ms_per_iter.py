"""The fused loop's device time per iteration: `FusedRun.replay_ms` (CUDA
events around the one graph launch) summed over the plans after the
profiled ones, over their iterations (layer: `runtime/graph.py`)."""


def read(ctx):
    its = sum(a.iterations for a in ctx.timed)
    return sum(a.launch_ms for a in ctx.timed) / its if its else None
