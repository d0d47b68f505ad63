"""K1: batched smallest-k selection (values + indices), ascending.

Replaces `trajopt_tpu/ops/pallas_topk.py::_select_kernel` (wrapped there by
`smallest_k`).  The CUDA kernel is ``csrc/topk.cu``: one thread block per
row, k rounds of block-wide (value, index) argmin, each round taking the
lexicographic successor of the previous pick.  On the card a row costs
about k block-reduction latencies after one read of its n values; rows run
in parallel.  Any n works (the slice needs n = 20000, which the TPU sent to
`lax.top_k`).

Semantics are `lax.top_k` on the negated input: distinct indices, ties to
the lowest index, +inf after every finite value.  The plain version is a
stable sort followed by a slice.
"""

from __future__ import annotations

import torch

from . import _cuda


def smallest_k_plain(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries along the last axis: (vals [..., k], idx [..., k])."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def smallest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries along the last axis (any leading batch shape).

    CPU tensors take `smallest_k_plain`; CUDA tensors launch K1 (float32,
    contiguous) or raise."""
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
    err = _cuda.lib().trajopt_smallest_k(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, n, k, _cuda.stream()
    )
    _cuda.check_launch(err, "smallest_k")
    return vals, idx
