"""K4, the Cholesky solve (`ops/cuda_chol.py`, `csrc/chol.cu`): its share of
its roofline over the traced plans, in % (`harness.roofline`)."""

from harness import roofline


def read(ctx):
    return roofline.share_pct("chol_solve", ctx.launch_shapes, ctx.trace)
