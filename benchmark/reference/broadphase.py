"""Broad-phase candidate generation as dense tensor math.

Port of `trajopt_tpu/ops/broadphase.py` (the per-robot tables and the
fleet-batched `fleet_candidates`): a segment's control-hull AABB, fattened
by the query radius, against every obstacle point, then the k nearest per
segment through kernel K1 (`ops/cuda_topk.py`).  `pairwise_robot_dist2`
and `topk_pair_candidates` have no caller in the reference and are not
ported.
"""

from __future__ import annotations

import torch

from .types import Candidates, Scene
from . import kernels as cuda_topk


def aabb_point_dist2(lo: torch.Tensor, hi: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Squared distance from each point to each AABB: lo/hi [..., 3],
    points [N, 3] -> [..., N]."""
    d = torch.clamp(lo[..., None, :] - points, min=0.0) + torch.clamp(
        points - hi[..., None, :], min=0.0
    )
    return torch.sum(d * d, dim=-1)


def hull_aabbs(hull: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AABBs of control hulls: [..., n, 3] -> ([..., 3], [..., 3])."""
    return hull.amin(dim=-2), hull.amax(dim=-2)


def topk_candidates(
    hull: torch.Tensor,        # [..., P, R, n, 3]
    scene: Scene,
    radius: float,
    k: int,
    coarse_k: int = 0,
) -> Candidates:
    """K nearest obstacles per segment by point-to-AABB distance, masked to
    those within ``radius`` of the hull AABB.

    ``coarse_k > 0`` enables the exact two-level filter: one per-piece
    selection over the whole cloud (a point within ``radius`` of any
    segment box is within ``radius`` of the piece box), then the
    per-segment selection over the ``coarse_k`` survivors.  If more than
    ``coarse_k`` points are within radius of a piece box the farthest are
    trimmed (`coarse_overflow` audits this).
    """
    lo, hi = hull_aabbs(hull)                              # [P,R,3]
    n_points = scene.points.shape[0]
    coarse_k = max(coarse_k, k) if coarse_k > 0 else 0
    if 0 < coarse_k < n_points:
        plo, phi = lo.amin(dim=-2), hi.amax(dim=-2)        # [P,3] piece boxes
        d2p = aabb_point_dist2(plo, phi, scene.points)     # [P,N]
        d2p = torch.where(scene.mask, d2p, float("inf"))
        _, cidx = cuda_topk.smallest_k(d2p, coarse_k)      # [P,Ck]
        sub = scene.points[cidx]                           # [P,Ck,3]
        subok = scene.mask[cidx]
        sub_r = sub[..., None, :, :]                       # [P,1,Ck,3]
        d = torch.clamp(lo[..., None, :] - sub_r, min=0.0) + torch.clamp(
            sub_r - hi[..., None, :], min=0.0
        )                                                  # [P,R,Ck,3]
        d2 = torch.where(subok[..., None, :], torch.sum(d * d, dim=-1), float("inf"))
        nd2, loc = cuda_topk.smallest_k(d2, k)             # [P,R,K]
        idx = torch.gather(cidx[..., None, :].expand(d2.shape[:-1] + (-1,)), -1, loc)
    else:
        d2 = aabb_point_dist2(lo, hi, scene.points)        # [P,R,N]
        d2 = torch.where(scene.mask, d2, float("inf"))
        nd2, idx = cuda_topk.smallest_k(d2, k)
    mask = nd2 <= radius * radius
    return Candidates(idx=idx, mask=mask, d2=nd2)


def fleet_candidates(
    hulls: torch.Tensor,       # [U, P, R, n, 3] all robots' segment hulls
    scene: Scene,
    radius: float,
    k: int,
    coarse_k: int = 64,
    piece_budget: int = 32,
) -> tuple[Candidates, torch.Tensor]:
    """Fleet-batched two-level candidate tables with dangerous-piece
    compaction: only the ``piece_budget`` pieces nearest the cloud run the
    coarse selection.  Exact unless the returned overflow flag is set (more
    than ``piece_budget`` pieces within ``radius``): a piece box farther
    than ``radius`` from every point has no candidate in any segment.

    Three K1 selections: the Wp nearest pieces ([1, U*P]), the coarse
    ``coarse_k`` points per selected piece ([Wp, N]) and the ``k`` nearest
    per segment among them ([Wp, R, Ck]).  Returns (Candidates [U,P,R,K],
    overflow)."""
    u, p, r = hulls.shape[:3]
    n_pts = scene.points.shape[0]
    up = u * p
    dtype, device = hulls.dtype, hulls.device
    lo, hi = hull_aabbs(hulls)                             # [U,P,R,3]
    lo_f = lo.reshape(up, r, 3)
    hi_f = hi.reshape(up, r, 3)
    plo = lo_f.amin(dim=1)                                 # [UP,3] piece boxes
    phi = hi_f.amax(dim=1)

    d2p = aabb_point_dist2(plo, phi, scene.points)         # [UP,N]
    d2p = torch.where(scene.mask, d2p, float("inf"))
    pmin = d2p.amin(dim=-1)                                # [UP]
    r2 = radius * radius
    wp = min(piece_budget, up)
    overflow = torch.sum(pmin <= r2) > wp

    k = min(k, n_pts)
    ck = min(max(coarse_k, k), n_pts)

    _, sel2 = cuda_topk.smallest_k(pmin[None].contiguous(), wp)
    sel = sel2[0]                                          # [Wp] piece ids

    d2s = aabb_point_dist2(plo[sel], phi[sel], scene.points)   # [Wp,N]
    d2s = torch.where(scene.mask, d2s, float("inf"))
    cvals, cidx = cuda_topk.smallest_k(d2s, ck)            # [Wp,Ck]
    sub = scene.points[cidx]                               # [Wp,Ck,3]

    slo, shi = lo_f[sel], hi_f[sel]                        # [Wp,R,3]
    d = torch.clamp(slo[:, :, None] - sub[:, None], min=0.0) + torch.clamp(
        sub[:, None] - shi[:, :, None], min=0.0
    )                                                      # [Wp,R,Ck,3]
    d2 = torch.sum(d * d, dim=-1)
    # dead coarse slots (masked points, short clouds) carry cvals == inf
    d2 = torch.where(torch.isfinite(cvals)[:, None], d2, float("inf"))
    nd2, loc = cuda_topk.smallest_k(d2, k)                 # [Wp,R,K]
    idx = torch.gather(cidx[:, None].expand(-1, r, -1), 2, loc)

    # scatter the compacted tables back to the full fleet layout (sel holds
    # distinct pieces, so the order of the writes does not matter)
    idx_full = torch.zeros((up, r, k), dtype=torch.int64, device=device).index_copy(0, sel, idx)
    d2_full = torch.full((up, r, k), float("inf"), dtype=dtype, device=device).index_copy(0, sel, nd2)
    mask_full = torch.zeros((up, r, k), dtype=torch.bool, device=device).index_copy(
        0, sel, nd2 <= r2
    )
    shape = (u, p, r, k)
    return (
        Candidates(idx=idx_full.reshape(shape), mask=mask_full.reshape(shape),
                   d2=d2_full.reshape(shape)),
        overflow,
    )


def coarse_overflow(hull: torch.Tensor, scene: Scene, radius: float, coarse_k: int) -> torch.Tensor:
    """[P] bool: does any piece box hold more than ``coarse_k`` in-radius
    points (so the two-level filter could drop a true candidate)?"""
    lo, hi = hull_aabbs(hull)
    plo, phi = lo.amin(dim=-2), hi.amax(dim=-2)
    d2p = aabb_point_dist2(plo, phi, scene.points)
    d2p = torch.where(scene.mask, d2p, float("inf"))
    return torch.sum(d2p <= radius * radius, dim=-1) > coarse_k
