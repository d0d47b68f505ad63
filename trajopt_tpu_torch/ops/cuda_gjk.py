"""K2: batched exact-simplex GJK distance from the origin to conv(u).

Replaces `trajopt_tpu/ops/pallas_gjk.py::_gjk_exact_kernel` (wrapped there
by `gjk_exact_diffset`).  The CUDA kernel is ``csrc/gjk.cu``.  On the card
it is bound by one thread's dependent arithmetic chain (15 closed-form
subset solves per iteration, at most 16 iterations on the solver's path,
32 in `initial_clearance`); the input is only N * m * 12 bytes.  Design:
one thread per problem with the simplex, Gram entries and best iterate in
registers, stopping a problem at convergence instead of iterating on a
frozen state.

The plain version is `ops/geometry.py::origin_simplex_dist` (the same
algorithm, batched); this module's `gjk_exact_plain` names it.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import geometry as geo


def gjk_exact_plain(u: torch.Tensor, iters: int) -> geo.HullDist:
    return geo.origin_simplex_dist(u, iters)


def gjk_exact(u: torch.Tensor, iters: int) -> geo.HullDist:
    """Distance from the origin to conv(u[i]) for u [N, m, 3].

    Returns HullDist(dist [N] upper bound, lb [N] certified lower bound,
    v [N, 3] witness).  CPU tensors take `gjk_exact_plain`; CUDA tensors
    launch K2 (float32, contiguous) or raise."""
    if u.ndim != 3 or u.shape[-1] != 3 or u.shape[1] < 1:
        raise ValueError(f"gjk_exact expects [N, m, 3], got {tuple(u.shape)}")
    if u.device.type == "cpu":
        return gjk_exact_plain(u, iters)
    _cuda.require_cuda_f32("gjk_exact", u)
    n, m, _ = u.shape
    dist = torch.empty(n, dtype=u.dtype, device=u.device)
    lb = torch.empty(n, dtype=u.dtype, device=u.device)
    v = torch.empty(n, 3, dtype=u.dtype, device=u.device)
    err = _cuda.lib().trajopt_gjk_exact(
        u.data_ptr(), dist.data_ptr(), lb.data_ptr(), v.data_ptr(), n, m, iters,
        _cuda.stream(),
    )
    _cuda.check_launch(err, "gjk_exact")
    return geo.HullDist(dist=dist, lb=lb, v=v)
