"""K2, the exact GJK distance (`ops/cuda_gjk.py`, `csrc/gjk.cu`): its share of
its roofline over the traced plans, in % (`harness.roofline`)."""

from harness import roofline


def read(ctx):
    return roofline.share_pct("gjk_exact", ctx.launch_shapes, ctx.trace)
