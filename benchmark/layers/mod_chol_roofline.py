"""K3, the modified Cholesky factor (`ops/cuda_chol.py`, `csrc/chol.cu`): its
share of its roofline over the traced plans, in % (`harness.roofline`)."""

from harness import roofline


def read(ctx):
    return roofline.share_pct("mod_chol", ctx.launch_shapes, ctx.trace)
