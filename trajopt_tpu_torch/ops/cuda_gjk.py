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
Frank-Wolfe solver with a pairwise away step, at any m as that kernel
takes.  The CUDA kernel is ``csrc/gjk_fw.cu``, routed by m and the batch
(`fw_route`): for m <= 64 a group of G lanes per problem (1 or 4 for large
batches, 8 for small ones) with each lane's vertices and weights in
registers (a round's reductions run over G lanes, and the two trial points
are closed forms of v); above, one warp per problem walking
its vertices in shared memory (m <= 512) or in device memory.  A round's
cost is the instructions and shuffles it issues per problem.  No solver
step calls it: it is the independent cross-check of the exact solver.
Plain version: `geometry.gjk_fw_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _cuda
from . import geometry as geo

# The register tier's builds, {G lanes a problem: vertices a lane} (the
# list TRAJOPT_FW_BUILDS of csrc/gjk_fw.cu); G = 2 is built for the G sweep
# only: it was never the fastest (PERF.md).
FW_VPL = {1: (1, 2, 3, 4, 6, 9, 12, 18, 24, 36), 2: (18,), 4: (1, 2, 3, 6, 9, 12, 16),
          8: (1, 2, 3, 5, 8)}
FW_ROUTE_G = (1, 4, 8)
# below 2 warps a streaming multiprocessor (132 on the H100) the card is
# mostly idle and a problem's serial chain sets the time: more lanes a
# problem shorten it; above, the fewest lanes issue the fewest instructions
FW_IDLE_LANES = 2 * 132 * 32
FW_SHARED_MAX_M = 512                     # 4 problems a block in 32 KB of shared memory
_FW_TIERS = {"registers": 0, "shared": 1, "device": 2}


class FwRoute(NamedTuple):
    tier: str   # "registers", "shared" or "device"
    g: int      # lanes a problem
    vpl: int    # vertices a lane held in registers (0: walked in memory)


def fw_route(m: int, n: int) -> FwRoute:
    """K5's route for n problems of m vertices.  Up to 64 vertices the
    register tier, with G lanes a problem from `FW_ROUTE_G` (G <= m, so no
    lane of a group is empty, and ceil(m / G) vertices a lane within the
    builds, in the fewest built slots that hold them): the largest such G
    whose n * G lanes stay within FW_IDLE_LANES, else the smallest (the
    timing matrix in PERF.md).  Above 64 vertices one warp a problem, its
    vertices in shared memory up to FW_SHARED_MAX_M and in device memory
    past that."""
    if m < 1:
        raise ValueError(f"K5 takes m >= 1 vertices, got {m}")
    fits = []
    for g in FW_ROUTE_G:
        need = -(-m // g)
        if g <= m and need <= FW_VPL[g][-1]:
            fits.append((g, next(v for v in FW_VPL[g] if v >= need)))
    if fits:
        idle = [f for f in fits if n * f[0] <= FW_IDLE_LANES]
        return FwRoute("registers", *(idle[-1] if idle else fits[0]))
    return FwRoute("shared" if m <= FW_SHARED_MAX_M else "device", 32, 0)


def gjk_exact_plain(u: torch.Tensor, iters: int) -> geo.HullDist:
    return geo.origin_simplex_dist(u, iters)


def _check_diffsets(name: str, u: torch.Tensor) -> None:
    if u.ndim != 3 or u.shape[-1] != 3 or u.shape[1] < 1:
        raise ValueError(f"{name} expects [N, m, 3], got {tuple(u.shape)}")


def gjk_exact(u: torch.Tensor, iters: int) -> geo.HullDist:
    """Distance from the origin to conv(u[i]) for u [N, m, 3].

    Returns HullDist(dist [N] upper bound, lb [N] certified lower bound,
    v [N, 3] witness).  CPU tensors take `gjk_exact_plain`; CUDA tensors
    launch K2 (float32, contiguous) or raise."""
    _check_diffsets("gjk_exact", u)
    if u.device.type == "cpu":
        return gjk_exact_plain(u, iters)
    _cuda.require_cuda_f32("gjk_exact", u)
    n, m, _ = u.shape
    dist = torch.empty(n, dtype=u.dtype, device=u.device)
    lb = torch.empty(n, dtype=u.dtype, device=u.device)
    v = torch.empty(n, 3, dtype=u.dtype, device=u.device)
    err = _cuda.lib().trajopt_gjk_exact(
        u.data_ptr(), dist.data_ptr(), lb.data_ptr(), v.data_ptr(), n, m, iters, _cuda.stream()
    )
    _cuda.check_launch(err, "gjk_exact", (u.shape, "iters", iters))
    return geo.HullDist(dist=dist, lb=lb, v=v)


def gjk_fw_plain(u: torch.Tensor, iters: int = 24) -> geo.HullDist:
    return geo.gjk_fw_plain(u, iters)


def _launch_fw(u: torch.Tensor, iters: int, route: FwRoute) -> geo.HullDist:
    _cuda.require_cuda_f32("gjk_fw", u)
    n, m, _ = u.shape
    dist = torch.empty(n, dtype=u.dtype, device=u.device)
    lb = torch.empty(n, dtype=u.dtype, device=u.device)
    v = torch.empty(n, 3, dtype=u.dtype, device=u.device)
    scratch = torch.empty(n * m if route.tier == "device" else 0, dtype=u.dtype, device=u.device)
    err = _cuda.lib().trajopt_gjk_fw(
        u.data_ptr(), dist.data_ptr(), lb.data_ptr(), v.data_ptr(), scratch.data_ptr(), n, m, iters,
        _FW_TIERS[route.tier], route.g, route.vpl, _cuda.stream(),
    )
    _cuda.check_launch(err, "gjk_fw", (u.shape, "iters", iters))
    return geo.HullDist(dist=dist, lb=lb, v=v)


def gjk_diffset(u: torch.Tensor, iters: int = 24) -> geo.HullDist:
    """Frank-Wolfe distance from the origin to conv(u[i]), u [N, m, 3], any
    m: HullDist(dist [N] upper bound, lb [N] certified lower bound,
    v [N, 3]).  CPU tensors take `gjk_fw_plain`; CUDA tensors launch K5 on
    the route `fw_route(m, N)` (float32, contiguous) or raise."""
    _check_diffsets("gjk_diffset", u)
    if u.device.type == "cpu":
        return gjk_fw_plain(u, iters)
    return _launch_fw(u, iters, fw_route(u.shape[1], u.shape[0]))


def gjk_diffset_group(u: torch.Tensor, iters: int, g: int) -> geo.HullDist:
    """A measurement aid: K5's register tier with ``g`` lanes a problem in
    the fewest built slots that hold ceil(m / g) vertices (the G sweep).  A
    (g, m) the kernel is not built for raises.  CUDA tensors only."""
    _check_diffsets("gjk_diffset_group", u)
    need = -(-u.shape[1] // g)
    return _launch_fw(u, iters, FwRoute("registers", g, next(v for v in FW_VPL[g] if v >= need)))


def gjk_pairs(a: torch.Tensor, b: torch.Tensor, iters: int = 24) -> geo.HullDist:
    """Batched hull-hull distance: a [N, ma, 3], b [N, mb, 3], any ma * mb;
    v points from B toward A."""
    return gjk_diffset(geo.minkowski_diff(a, b).contiguous(), iters)


def gjk_points(verts: torch.Tensor, points: torch.Tensor, iters: int = 24) -> geo.HullDist:
    """Batched point-hull distance: verts [N, m, 3], points [N, 3]."""
    return gjk_diffset((verts - points[:, None, :]).contiguous(), iters)
