"""K1: batched smallest-k selection (values + indices), ascending.

Replaces `trajopt_tpu/ops/pallas_topk.py::_select_kernel` (wrapped there by
`smallest_k`).  The CUDA kernels are in ``csrc/topk.cu``, one route per row
shape (`route`):

- ``"warp"`` (n <= 256, k <= 32): one warp per row, the row's keys sorted
  in the lanes' registers, k rounds of two warp min-reductions;
- ``"radix"`` (any other row with k <= 1024): one block per row, the row in
  shared memory (in device memory past the card's 227 KB), a four-pass
  8-bit radix select of the k-th key, one gather pass and a rank sort of
  the k picks; its cost is nearly flat in k, where a warp round costs
  about 0.1 us, so past k = 32 it is the faster of the two on short rows;
- ``"rounds"`` (k > 1024): k rounds of block-wide argmin.  No solver call
  takes it.

On the card a row is latency-bound: it is read once and the routes keep the
dependent chain short (`PERF.md`).  Any n works (the slice needs n = 20000,
which the TPU sent to `lax.top_k`).

Semantics are a stable ascending sort: distinct indices, ties to the lowest
index, -0.0 tied with +0.0 (each output keeps the input's own float), +inf
after every finite value, NaN after +inf.  The plain version is a stable
sort followed by a slice.  `lax.top_k` on the negated input agrees except
that it orders -0.0 before +0.0; the Pallas kernel ties them, as here.
"""

from __future__ import annotations

import torch

from . import _cuda

WARP_MAX_N = 256     # rows this short, with few picks, take the warp route
WARP_MAX_K = 32
RADIX_MAX_K = 1024   # the radix route's rank sort holds this many picks


def route(n: int, k: int) -> str:
    """The kernel route for rows of n entries and k picks (by shape only)."""
    if n <= WARP_MAX_N and k <= WARP_MAX_K:
        return "warp"
    return "radix" if k <= RADIX_MAX_K else "rounds"


def smallest_k_plain(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries along the last axis: (vals [..., k], idx [..., k])."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def smallest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries along the last axis (any leading batch shape).

    CPU tensors take `smallest_k_plain`; CUDA tensors launch K1 (float32,
    contiguous) on the route `route(n, k)` picks, or raise."""
    n = x.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"smallest_k needs 0 < k <= n, got k={k}, n={n}")
    if x.device.type == "cpu":
        return smallest_k_plain(x, k)
    _cuda.require_cuda_f32("smallest_k", x)
    lead = x.shape[:-1]
    rows = x.numel() // n
    vals = torch.empty(lead + (k,), dtype=x.dtype, device=x.device)
    idx = torch.empty(lead + (k,), dtype=torch.int64, device=x.device)
    launch = getattr(_cuda.lib(), f"trajopt_smallest_k_{route(n, k)}")
    err = launch(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, n, k, _cuda.stream())
    _cuda.check_launch(err, "smallest_k", (x.shape, "k", k))
    return vals, idx
