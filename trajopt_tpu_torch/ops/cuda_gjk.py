"""K2 and K5: batched GJK distances from the origin to conv(u).

K2, `gjk_exact`, replaces `trajopt_tpu/ops/pallas_gjk.py::_gjk_exact_kernel`
(wrapped there by `gjk_exact_diffset`).  The CUDA kernel is
``csrc/gjk.cu``.  On the card it is bound by the latency of each round's
dependent chain (at most 16 rounds on the solver's path); the input is only
N * m * 12 bytes.  Design: one group of 16 lanes per problem, two problems
a warp.  Each lane keeps its vertices j = lane (mod 16), scaled, in
registers (m <= 64; a larger m is read again from device memory), solves
one of the 15 vertex subsets a round, and group argmins pick the subset and
the support vertex; a problem stops at convergence instead of iterating on
a frozen state.  Plain version: `geometry.origin_simplex_dist`.

K5, `gjk_diffset` / `gjk_pairs` / `gjk_points`, replaces
`trajopt_tpu/ops/pallas_gjk.py::_gjk_kernel`, the fixed-iteration
Frank-Wolfe solver with a pairwise away step.  The CUDA kernel is
``csrc/gjk_fw.cu``: one warp per problem, vertex j on lane j % 32, so
m <= 64.  It is bound by the latency of its shuffle reductions (11 per
round).  No solver step calls it: it is the independent cross-check of the
exact solver.  Plain version: `geometry.gjk_fw_plain`.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import geometry as geo

FW_MAX_M = 64   # two vertices per lane of one warp


def gjk_exact_plain(u: torch.Tensor, iters: int) -> geo.HullDist:
    return geo.origin_simplex_dist(u, iters)


def _check_diffsets(name: str, u: torch.Tensor) -> None:
    if u.ndim != 3 or u.shape[-1] != 3 or u.shape[1] < 1:
        raise ValueError(f"{name} expects [N, m, 3], got {tuple(u.shape)}")


def _launch(name: str, symbol: str, u: torch.Tensor, iters: int) -> geo.HullDist:
    _cuda.require_cuda_f32(name, u)
    n, m, _ = u.shape
    dist = torch.empty(n, dtype=u.dtype, device=u.device)
    lb = torch.empty(n, dtype=u.dtype, device=u.device)
    v = torch.empty(n, 3, dtype=u.dtype, device=u.device)
    err = getattr(_cuda.lib(), symbol)(
        u.data_ptr(), dist.data_ptr(), lb.data_ptr(), v.data_ptr(), n, m, iters, _cuda.stream()
    )
    _cuda.check_launch(err, name, (u.shape, "iters", iters))
    return geo.HullDist(dist=dist, lb=lb, v=v)


def gjk_exact(u: torch.Tensor, iters: int) -> geo.HullDist:
    """Distance from the origin to conv(u[i]) for u [N, m, 3].

    Returns HullDist(dist [N] upper bound, lb [N] certified lower bound,
    v [N, 3] witness).  CPU tensors take `gjk_exact_plain`; CUDA tensors
    launch K2 (float32, contiguous) or raise."""
    _check_diffsets("gjk_exact", u)
    if u.device.type == "cpu":
        return gjk_exact_plain(u, iters)
    return _launch("gjk_exact", "trajopt_gjk_exact", u, iters)


def gjk_fw_plain(u: torch.Tensor, iters: int = 24) -> geo.HullDist:
    return geo.gjk_fw_plain(u, iters)


def gjk_diffset(u: torch.Tensor, iters: int = 24) -> geo.HullDist:
    """Frank-Wolfe distance from the origin to conv(u[i]), u [N, m, 3] with
    m <= 64: HullDist(dist [N] upper bound, lb [N] certified lower bound,
    v [N, 3]).  CPU tensors take `gjk_fw_plain`; CUDA tensors launch K5
    (float32, contiguous) or raise."""
    _check_diffsets("gjk_diffset", u)
    if u.device.type == "cpu":
        return gjk_fw_plain(u, iters)
    if u.shape[1] > FW_MAX_M:
        raise ValueError(f"gjk_diffset kernel takes m <= {FW_MAX_M}, got {u.shape[1]}")
    return _launch("gjk_fw", "trajopt_gjk_fw", u, iters)


def gjk_pairs(a: torch.Tensor, b: torch.Tensor, iters: int = 24) -> geo.HullDist:
    """Batched hull-hull distance: a [N, ma, 3], b [N, mb, 3] (ma * mb <= 64
    on the card); v points from B toward A."""
    return gjk_diffset(geo.minkowski_diff(a, b).contiguous(), iters)


def gjk_points(verts: torch.Tensor, points: torch.Tensor, iters: int = 24) -> geo.HullDist:
    """Batched point-hull distance: verts [N, m, 3], points [N, 3]."""
    return gjk_diffset((verts - points[:, None, :]).contiguous(), iters)
