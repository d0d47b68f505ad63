"""K1, the smallest-k selection (`ops/cuda_topk.py`, `csrc/topk.cu`): its share
of its roofline over the traced plans, in % (`harness.roofline`)."""

from harness import roofline


def read(ctx):
    return roofline.share_pct("smallest_k", ctx.launch_shapes, ctx.trace)
