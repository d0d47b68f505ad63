"""K3 and K4 in one launch (`ops/cuda_chol.py`, `csrc/chol.cu`): its share of
its roofline over the traced plans, in % (`harness.roofline`)."""

from harness import roofline


def read(ctx):
    return roofline.share_pct("factor_solve", ctx.launch_shapes, ctx.trace)
