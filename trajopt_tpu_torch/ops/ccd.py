"""Sound conservative CCD: the three-level analytic max-step certificate.

Port of `trajopt_tpu/ops/ccd.py::obstacle_max_step_direct` and its helpers.
For every (segment, obstacle point) pair a certified largest step is
computed at three per-segment levels, each sound via select-(K+1)-and-cap:

1. AABB level: 3-axis analytic sweep limits for every pair; the S1
   smallest per segment go to level 2 (K1), the (S1+1)-th caps.
2. k-DOP level: exact per-vertex 49-axis limits on the S1 candidates; the
   S2 smallest go to level 3 (K1), the (S2+1)-th caps.
3. GJK: exact static distance (K2) plus a Lipschitz/directional rate.

Levels 2-3 run only on the ``seg_budget`` segments with the smallest
level-1 limits; every other segment keeps its own exact level-1 limit.
The two `lax.cond` gates of the JAX package are Python branches here (one
host sync each).
"""

from __future__ import annotations

import functools

import torch

from . import cuda_topk
from . import geometry as geo


@functools.cache
def _axes(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[D,3] unit k-DOP axes, uploaded once per device and dtype."""
    return torch.as_tensor(geo.kdop_axes(), dtype=dtype, device=device)


def _side_limit(gap0, spd):
    """Largest s with gap0 - s*spd > 0: +inf if spd == 0, -inf if gap0 <= 0."""
    safe = torch.where(spd > 0, spd, 1.0)
    lim = torch.where(spd > 0, gap0 / safe, float("inf"))
    return torch.where(gap0 > 0, lim, -float("inf"))


def _hull_speed(dp):
    """Per-axis one-sided sweep speeds (max_n relu(dp), max_n relu(-dp)):
    [..., n, D] -> ([..., D], [..., D])."""
    return torch.clamp(dp, min=0.0).amax(dim=-2), torch.clamp(-dp, min=0.0).amax(dim=-2)


def _disp_norm(dhull):
    """[..., n, 3] -> [...]: max vertex displacement (Lipschitz rate)."""
    return torch.sqrt(torch.sum(dhull * dhull, dim=-1)).amax(dim=-1)


def _level1(hull_f, dhull_f, points, pmask, offset):
    """3-axis analytic limits of every (segment, point): [S,n,3] -> [S,N]."""
    lo3, hi3 = hull_f.amin(dim=-2), hull_f.amax(dim=-2)
    sp_hi, sp_lo = _hull_speed(dhull_f)
    s0 = None
    for a in range(3):
        pa = points[:, a][None, :]
        g_hi = pa - hi3[:, a][:, None] - offset
        g_lo = lo3[:, a][:, None] - pa - offset
        s_a = torch.maximum(
            _side_limit(g_hi, sp_hi[:, a][:, None]),
            _side_limit(g_lo, sp_lo[:, a][:, None]),
        )
        s0 = s_a if s0 is None else torch.maximum(s0, s_a)
    return torch.where(pmask[None, :], torch.clamp(s0, min=0.0), float("inf"))


def obstacle_max_step_direct(
    hull, dhull, points, pmask, offset, gjk_iters,
    s1_slots: int = 32, n_slots: int = 32, seg_budget: int = 64,
) -> torch.Tensor:
    """[B] largest provably safe step per robot against the cloud.

    ``hull``/``dhull``: [B,P,R,n,3]; ``points`` [N,3]; ``pmask`` [N].
    Clipped to [0, 1 + 1e-6]: `rung_floor` admits a rung only strictly
    below the limit, so an unconstrained step must stay distinguishable
    from a limit of exactly 1.
    """
    b, p, r, n, _ = hull.shape
    n_seg = b * p * r
    s0 = _level1(hull.reshape(n_seg, n, 3), dhull.reshape(n_seg, n, 3), points, pmask, offset)
    s_seg_min = s0.amin(dim=-1)                          # [S]
    # plateau regime: every (segment, point) limit certifies the full step
    if bool(s_seg_min.amin() >= 1.0):
        s_b = s_seg_min.reshape(b, p, r).amin(dim=(-1, -2))
    else:
        s_b = _obstacle_levels_23(
            hull, dhull, points, pmask, s_seg_min, offset, gjk_iters,
            s1_slots, n_slots, seg_budget,
        )
    return torch.clamp(s_b, 0.0, 1.0 + 1e-6)


def _obstacle_levels_23(
    hull, dhull, points, pmask, s_seg_min, offset, gjk_iters,
    s1_slots, n_slots, seg_budget,
):
    """Levels 2-3 of `obstacle_max_step_direct` on the W = ``seg_budget``
    segments with the smallest level-1 limits.  Refinement only raises a
    selected segment's limit, so the compaction cannot accept an unsafe
    step; an overfull danger set only keeps extra segments at their
    conservative level-1 values."""
    b, p, r, n, _ = hull.shape
    n_seg = b * p * r
    n_pts = points.shape[0]
    dtype, device = hull.dtype, hull.device
    w = min(seg_budget, n_seg)

    _, sel2 = cuda_topk.smallest_k(s_seg_min[None].contiguous(), w)
    sel = sel2[0]                                        # [W] segment ids
    hull_f = hull.reshape(n_seg, n, 3)[sel]
    dhull_f = dhull.reshape(n_seg, n, 3)[sel]

    # level-1 rows recomputed for the selected segments
    s0 = _level1(hull_f, dhull_f, points, pmask, offset)  # [W,N]
    s1 = min(s1_slots, n_pts)
    k1 = min(s1 + 1, n_pts)
    s_all1, idx1_all = cuda_topk.smallest_k(s0, k1)
    s3_sel = s_all1[:, :s1]
    idx1 = idx1_all[:, :s1]                              # [W,S1] cloud ids
    cap1 = s_all1[:, -1] if k1 > s1 else torch.full((w,), float("inf"), dtype=dtype, device=device)

    # level 2: exact per-vertex k-DOP limits on the S1 candidates
    ax = _axes(device, dtype)
    hp = hull_f @ ax.T                                   # [W,n,D]
    dp = dhull_f @ ax.T
    sel_pts1 = points[idx1]                              # [W,S1,3]
    sel_proj = (
        sel_pts1[..., 0:1] * ax[:, 0]
        + sel_pts1[..., 1:2] * ax[:, 1]
        + sel_pts1[..., 2:3] * ax[:, 2]
    )                                                    # [W,S1,D]
    g1 = sel_proj[:, :, None, :] - hp[:, None] - offset  # [W,S1,n,D]
    side1 = _side_limit(g1, dp[:, None]).amin(dim=-2)
    g2 = hp[:, None] - sel_proj[:, :, None, :] - offset
    side2 = _side_limit(g2, -dp[:, None]).amin(dim=-2)
    s_kd = torch.maximum(side1, side2).amax(dim=-1)      # [W,S1]
    # both certificates are sound; keep the tighter
    s_kd = torch.maximum(torch.clamp(s_kd, min=0.0), s3_sel)
    s_kd = torch.where(torch.isfinite(s3_sel), s_kd, float("inf"))

    s2 = min(n_slots, s1)
    k2 = min(s2 + 1, s1)
    s_all, loc_all = cuda_topk.smallest_k(s_kd, k2)
    s_sel, loc = s_all[:, :s2], loc_all[:, :s2]
    cap2 = s_all[:, -1] if k2 > s2 else torch.full((w,), float("inf"), dtype=dtype, device=device)
    idx2 = torch.gather(idx1, 1, loc)                    # [W,S2] cloud ids

    # level 3: GJK + directional Lipschitz refinement, only when it can
    # matter (some selected limit below the full step); skipping is
    # strictly conservative
    if bool(s_sel.amin() < 1.0):
        sel_pts = points[idx2]                           # [W,S2,3]
        diff = (hull_f[:, None] - sel_pts[..., None, :]).reshape(-1, n, 3)
        hd = geo.batched_origin_dist(diff, gjk_iters)
        dist0 = hd.lb.reshape(idx2.shape)
        disp = _disp_norm(dhull_f)                       # [W]
        s_ref = (dist0 - offset) / torch.clamp(disp[:, None], min=1e-12)
        # directional bound: for any unit c, dist(s) >= min_n(u_n . c)
        # + s * min_n(dd_n . c); with c = the GJK witness direction the rate
        # is the velocity component along the separation normal.  Sound for
        # any unit c, so a degenerate witness only loses tightness.
        vn = torch.sqrt(torch.sum(hd.v ** 2, dim=-1))
        c = hd.v / torch.clamp(vn, min=1e-12)[:, None]   # [W*S2,3]
        lcert = torch.einsum("bnd,bd->bn", diff, c).amin(dim=-1)
        dd = torch.broadcast_to(dhull_f[:, None], idx2.shape + (n, 3)).reshape(-1, n, 3)
        rate = -torch.einsum("bnd,bd->bn", dd, c).amin(dim=-1)
        s_dir = torch.where(
            rate > 0, (lcert - offset) / torch.clamp(rate, min=1e-12), float("inf")
        )
        s_dir = torch.where(lcert > offset, s_dir, -float("inf"))
        s_ref = torch.maximum(s_ref, s_dir.reshape(idx2.shape))
        s_ref = torch.maximum(s_sel, torch.clamp(s_ref, min=0.0))
    else:
        s_ref = s_sel
    seg_ref = torch.minimum(s_ref.amin(dim=-1), torch.minimum(cap1, cap2))

    # scatter refined limits back to robots
    rob = sel // (p * r)                                 # [W] owning robot
    s_b = torch.full((b,), float("inf"), dtype=dtype, device=device)
    s_b = s_b.scatter_reduce(0, rob, seg_ref, "amin", include_self=True)
    unsel = s_seg_min.clone()
    unsel[sel] = float("inf")
    unsel = unsel.reshape(b, p, r).amin(dim=(-1, -2))
    return torch.minimum(s_b, unsel)                     # [B]
