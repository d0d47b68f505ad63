"""Broad-phase candidate generation as dense tensor math.

Port of the single-robot part of `trajopt_tpu/ops/broadphase.py`: a
segment's control-hull AABB, fattened by the query radius, against every
obstacle point, then the k nearest per segment through kernel K1
(`ops/cuda_topk.py`).
"""

from __future__ import annotations

import torch

from ..types import Candidates, Scene
from . import cuda_topk


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
    hull: torch.Tensor,        # [P, R, n, 3]
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
        d = torch.clamp(lo[..., None, :] - sub[:, None], min=0.0) + torch.clamp(
            sub[:, None] - hi[..., None, :], min=0.0
        )                                                  # [P,R,Ck,3]
        d2 = torch.where(subok[:, None], torch.sum(d * d, dim=-1), float("inf"))
        nd2, loc = cuda_topk.smallest_k(d2, k)             # [P,R,K]
        idx = torch.gather(cidx[:, None].expand(-1, d2.shape[1], -1), 2, loc)
    else:
        d2 = aabb_point_dist2(lo, hi, scene.points)        # [P,R,N]
        d2 = torch.where(scene.mask, d2, float("inf"))
        nd2, idx = cuda_topk.smallest_k(d2, k)
    mask = nd2 <= radius * radius
    return Candidates(idx=idx, mask=mask, d2=nd2)


def coarse_overflow(hull: torch.Tensor, scene: Scene, radius: float, coarse_k: int) -> torch.Tensor:
    """[P] bool: does any piece box hold more than ``coarse_k`` in-radius
    points (so the two-level filter could drop a true candidate)?"""
    lo, hi = hull_aabbs(hull)
    plo, phi = lo.amin(dim=-2), hi.amax(dim=-2)
    d2p = aabb_point_dist2(plo, phi, scene.points)
    d2p = torch.where(scene.mask, d2p, float("inf"))
    return torch.sum(d2p <= radius * radius, dim=-1) > coarse_k
