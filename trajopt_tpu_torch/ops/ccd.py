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
The robot-pair CCD (`pair_max_step_direct` for the coupled step,
`build_pair_ccd` + `pair_bad` for the decoupled shrink fixpoint) follows
the same scheme on (segment, partner robot) pairs.  Each `lax.cond` gate of
the JAX package is a `runtime.graph.device_cond`: a Python branch (one host
sync) in the host-stepped solve, an IF node of the CUDA graph in a fused one.
Under the tracing switch `obstacle_max_step_direct` counts the segments
whose level-1 limit is below the full step (`runtime.trace`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..runtime import graph, trace
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
    # segments levels 2-3 have work on (before the seg_budget cap)
    trace.count("ccd_live_segments", lambda: (s_seg_min < 1.0).sum())
    # plateau regime: every (segment, point) limit certifies the full step
    s_b = graph.device_cond(
        s_seg_min.amin() >= 1.0,
        lambda: s_seg_min.reshape(b, p, r).amin(dim=(-1, -2)),
        lambda: _obstacle_levels_23(hull, dhull, points, pmask, s_seg_min, offset, gjk_iters,
                                    s1_slots, n_slots, seg_budget),
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
    def refine():
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
        return torch.maximum(s_sel, torch.clamp(s_ref, min=0.0))

    s_ref = graph.device_cond(s_sel.amin() < 1.0, refine, lambda: s_sel)
    seg_ref = torch.minimum(s_ref.amin(dim=-1), torch.minimum(cap1, cap2))

    # scatter refined limits back to robots
    rob = sel // (p * r)                                 # [W] owning robot
    s_b = torch.full((b,), float("inf"), dtype=dtype, device=device)
    s_b = s_b.scatter_reduce(0, rob, seg_ref, "amin", include_self=True)
    # index_fill with a scalar: an indexed store of a Python float would
    # cost a host sync on the card
    unsel = s_seg_min.index_fill(0, sel, float("inf")).reshape(b, p, r).amin(dim=(-1, -2))
    return torch.minimum(s_b, unsel)                     # [B]


# ---------------------------------------------------------------------------
# Robot-pair CCD (equal-time segment hulls against each other)
# ---------------------------------------------------------------------------


def _interval(proj):
    """(lo, hi) over the vertex axis of a projection [..., n, D]."""
    return proj.amin(dim=-2), proj.amax(dim=-2)


def partners(gids: torch.Tensor, ut: int, groups: int = 1) -> torch.Tensor:
    """[U, Ut] bool: fleet robot j may constrain local robot i, i.e. it is
    another robot and, in a fleet of ``groups`` contiguous equal groups (a
    scenario-grouped batch), one of the same group."""
    other = torch.arange(ut, device=gids.device)[None, :]
    mask = gids[:, None] != other
    if groups > 1:
        upg = ut // groups
        mask = mask & (gids[:, None] // upg == other // upg)
    return mask


def pair_max_step_direct(
    my_hulls, my_dhulls, all_hulls, all_dhulls, gids, offset, gjk_iters,
    k_partners: int = 8, n_slots: int = 8, groups: int = 1,
) -> torch.Tensor:
    """[U] largest provably safe common step per robot against every other
    robot (Step::couple_self_step semantics), the per-segment three-level
    scheme of `obstacle_max_step_direct`:

    1. AABB level: 3-axis pair limits for every (segment, partner); the K1
       smallest partners per segment go to level 2 (K1), the (K1+1)-th caps.
    2. k-DOP level: 49-axis limits on the selected partners; the S2
       smallest go to level 3 (K1), the (S2+1)-th caps.
    3. GJK (K2) on the 36-vertex static differences + a Lipschitz and a
       directional rate.

    ``my_*``: [U,P,R,n,3] local robots; ``all_*``: [Ut,P,R,n,3] the fleet;
    ``gids``: [U] fleet ids of the local robots; with ``groups > 1`` only
    robots of the same group constrain each other (`partners`).  The
    plateau gate is a `device_cond`."""
    ut = all_hulls.shape[0]
    lo3_a, hi3_a = _interval(my_hulls)                   # [U,P,R,3]
    lo3_b, hi3_b = _interval(all_hulls)                  # [Ut,P,R,3]
    sp3_hi_a, sp3_lo_a = _hull_speed(my_dhulls)
    sp3_hi_b, sp3_lo_b = _hull_speed(all_dhulls)
    g1 = lo3_a[:, None] - hi3_b[None] - offset           # [U,Ut,P,R,3]
    s1_ = _side_limit(g1, sp3_lo_a[:, None] + sp3_hi_b[None])
    g2 = lo3_b[None] - hi3_a[:, None] - offset
    s2_ = _side_limit(g2, sp3_hi_a[:, None] + sp3_lo_b[None])
    s3 = torch.maximum(s1_, s2_).amax(dim=-1)            # [U,Ut,P,R]
    s3 = s3.permute(0, 2, 3, 1)                          # [U,P,R,Ut]
    s3 = torch.where(partners(gids, ut, groups)[:, None, None, :], torch.clamp(s3, min=0.0),
                     float("inf")).contiguous()
    s_seg_min = s3.amin(dim=-1)                          # [U,P,R]
    # plateau regime: every pair limit certifies the full step
    s_u = graph.device_cond(
        s_seg_min.amin() >= 1.0,
        lambda: s_seg_min.amin(dim=(-1, -2)),
        lambda: _pair_levels_23(my_hulls, my_dhulls, all_hulls, all_dhulls, s3, offset,
                                gjk_iters, k_partners, n_slots),
    )
    return torch.clamp(s_u, 0.0, 1.0 + 1e-6)


def _pair_levels_23(my_hulls, my_dhulls, all_hulls, all_dhulls, s3, offset, gjk_iters,
                    k_partners, n_slots):
    """Levels 2-3 of `pair_max_step_direct`: partner selection, k-DOP and
    GJK, taken only when some level-1 pair limit is below the full step."""
    u, p, r, n, _ = my_hulls.shape
    ut = all_hulls.shape[0]
    dtype, device = my_hulls.dtype, my_hulls.device

    kp = min(k_partners, max(ut - 1, 1))
    k1 = min(kp + 1, ut)
    s3_all, part_all = cuda_topk.smallest_k(s3, k1)      # [U,P,R,K1(+1)]
    s3_sel = s3_all[..., :kp]
    part = part_all[..., :kp]                            # [U,P,R,K1] fleet ids
    inf = torch.full(s3_all.shape[:-1], float("inf"), dtype=dtype, device=device)
    cap1 = s3_all[..., -1] if k1 > kp else inf

    ax = _axes(device, dtype)

    def proj(x):   # [..., n, 3] -> [..., n, D]
        return x[..., 0:1] * ax[:, 0] + x[..., 1:2] * ax[:, 1] + x[..., 2:3] * ax[:, 2]

    lo_a0, hi_a0 = _interval(proj(my_hulls))             # [U,P,R,D]
    spd_hi_a, spd_lo_a = _hull_speed(proj(my_dhulls))
    p_idx = torch.arange(p, device=device)[None, :, None, None]
    r_idx = torch.arange(r, device=device)[None, None, :, None]
    sel_hulls1 = all_hulls[part, p_idx, r_idx]           # [U,P,R,K1,n,3]
    sel_dhulls1 = all_dhulls[part, p_idx, r_idx]
    sel_lo_b, sel_hi_b = _interval(proj(sel_hulls1))     # [U,P,R,K1,D]
    sel_s_hi_b, sel_s_lo_b = _hull_speed(proj(sel_dhulls1))
    g1 = lo_a0[..., None, :] - sel_hi_b - offset
    s1k = _side_limit(g1, spd_lo_a[..., None, :] + sel_s_hi_b)
    g2 = sel_lo_b - hi_a0[..., None, :] - offset
    s2k = _side_limit(g2, spd_hi_a[..., None, :] + sel_s_lo_b)
    s_kd = torch.maximum(s1k, s2k).amax(dim=-1)          # [U,P,R,K1]
    s_kd = torch.maximum(torch.clamp(s_kd, min=0.0), s3_sel)
    s_kd = torch.where(torch.isfinite(s3_sel), s_kd, float("inf"))

    s2n = min(n_slots, kp)
    k2 = min(s2n + 1, kp)
    s_all, loc_all = cuda_topk.smallest_k(s_kd.contiguous(), k2)   # [U,P,R,S2(+1)]
    s_sel, loc = s_all[..., :s2n], loc_all[..., :s2n]
    cap2 = s_all[..., -1] if k2 > s2n else inf

    # level 3 only when it can matter (some selected limit below the full
    # step); skipping is strictly conservative
    def refine():
        take = loc[..., None, None].expand(loc.shape + (n, 3))
        sel_hulls = torch.gather(sel_hulls1, 3, take)    # [U,P,R,S2,n,3]
        sel_dhulls = torch.gather(sel_dhulls1, 3, take)
        diff = geo.minkowski_diff(my_hulls[:, :, :, None], sel_hulls)   # [U,P,R,S2,n*n,3]
        hd = geo.batched_origin_dist(diff.reshape(-1, n * n, 3), gjk_iters)
        dist0 = hd.lb.reshape(loc.shape)
        disp = _disp_norm(my_dhulls)[..., None] + _disp_norm(sel_dhulls)
        s_ref = (dist0 - offset) / torch.clamp(disp, min=1e-12)
        # directional bound along the GJK witness: the difference vertices
        # move at (da_i - db_j), so the closing rate along c is
        # max_j(db_j . c) - min_i(da_i . c)
        vn = torch.sqrt(torch.sum(hd.v ** 2, dim=-1))
        c = (hd.v / torch.clamp(vn, min=1e-12)[:, None]).reshape(loc.shape + (3,))
        lcert = torch.einsum("uprsmd,uprsd->uprsm", diff, c).amin(dim=-1)
        da_c = torch.einsum("uprnd,uprsd->uprsn", my_dhulls, c)
        db_c = torch.einsum("uprsnd,uprsd->uprsn", sel_dhulls, c)
        rate = db_c.amax(dim=-1) - da_c.amin(dim=-1)
        s_dir = torch.where(rate > 0, (lcert - offset) / torch.clamp(rate, min=1e-12),
                            float("inf"))
        s_dir = torch.where(lcert > offset, s_dir, -float("inf"))
        s_ref = torch.maximum(s_ref, s_dir)
        return torch.maximum(s_sel, torch.clamp(s_ref, min=0.0))

    s_ref = graph.device_cond(s_sel.amin() < 1.0, refine, lambda: s_sel)
    s_seg = torch.minimum(s_ref.amin(dim=-1), torch.minimum(cap1, cap2))
    return s_seg.amin(dim=(-1, -2))                      # [U]


class PairCCD(NamedTuple):
    """Robot-pair CCD tables for the decoupled per-robot step fixpoint."""

    my_hull: torch.Tensor    # [U,P,R,n,3]
    my_dhull: torch.Tensor
    my_hp: torch.Tensor      # [U,P,R,n,D] k-DOP projections
    my_dp: torch.Tensor
    all_hulls: torch.Tensor  # [Ut,P,R,n,3]
    all_dhulls: torch.Tensor
    all_hp: torch.Tensor     # [Ut,P,R,n,D]
    all_dp: torch.Tensor
    not_self: torch.Tensor   # [U,Ut] bool
    n_slots: int


def build_pair_ccd(my_hulls, my_dhulls, all_hulls, all_dhulls, gids, k_gjk: int,
                   groups: int = 1) -> PairCCD:
    """``my_*``: [U,P,R,n,3] local robots; ``all_*``: [Ut,...] the fleet;
    ``gids``: [U] fleet ids of the local robots; ``groups`` as in
    `pair_max_step_direct`."""
    ax_t = _axes(my_hulls.device, my_hulls.dtype).T
    ut = all_hulls.shape[0]
    return PairCCD(
        my_hull=my_hulls, my_dhull=my_dhulls, my_hp=my_hulls @ ax_t, my_dp=my_dhulls @ ax_t,
        all_hulls=all_hulls, all_dhulls=all_dhulls,
        all_hp=all_hulls @ ax_t, all_dp=all_dhulls @ ax_t,
        not_self=partners(gids, ut, groups),
        n_slots=max(1, min(2 * k_gjk, ut)),
    )


def _swept_interval(hp, dp, step):
    """k-DOP interval of the swept hull {P} u {P + step*D}: [..., n, D] ->
    [..., D] bounds, widening monotonically with ``step``."""
    lo0, hi0 = _interval(hp)
    lo1, hi1 = _interval(hp + step * dp)
    return torch.minimum(lo0, lo1), torch.maximum(hi0, hi1)


def pair_bad(tabs: PairCCD, my_steps, all_steps, offset, gjk_iters) -> torch.Tensor:
    """[U] bool: some pair involving each local robot is not certified with
    per-robot step intervals [0, s_i] x [0, s_j] (Step::self_step).

    The S smallest-gap partners per segment get a GJK test (K1 selects
    them, K2 runs it on the 4n^2-vertex swept differences); more than S
    uncleared partners in one segment is conservatively inadmissible.  The
    GJK gate (some selected pair uncleared) is a `device_cond`."""
    _, p, r, n, _ = tabs.my_hull.shape
    sm = my_steps[:, None, None, None, None]
    sa = all_steps[:, None, None, None, None]
    lo_a, hi_a = _swept_interval(tabs.my_hp, tabs.my_dp, sm)
    lo_b, hi_b = _swept_interval(tabs.all_hp, tabs.all_dp, sa)
    gap = torch.maximum(lo_a[:, None] - hi_b[None], lo_b[None] - hi_a[:, None]).amax(dim=-1)
    m = gap.permute(0, 2, 3, 1)                          # [U,P,R,Ut]
    unc = tabs.not_self[:, None, None, :] & ~(m > offset)
    s_slots = tabs.n_slots
    over = torch.any(unc.sum(dim=-1) > s_slots, dim=-1).any(dim=-1)   # [U]
    gm = torch.where(unc, m, float("inf")).contiguous()
    _, idx = cuda_topk.smallest_k(gm, s_slots)           # [U,P,R,S]
    sel_unc = torch.gather(unc, -1, idx)

    def certify():
        p_idx = torch.arange(p, device=idx.device)[None, :, None, None]
        r_idx = torch.arange(r, device=idx.device)[None, None, :, None]
        sel_hulls = tabs.all_hulls[idx, p_idx, r_idx]    # [U,P,R,S,n,3]
        sel_dhulls = tabs.all_dhulls[idx, p_idx, r_idx]
        so = all_steps[idx][..., None, None]
        swept_a = torch.cat([tabs.my_hull, tabs.my_hull + sm * tabs.my_dhull], dim=-2)
        swept_b = torch.cat([sel_hulls, sel_hulls + so * sel_dhulls], dim=-2)
        diff = geo.minkowski_diff(swept_a[:, :, :, None], swept_b).reshape(-1, 4 * n * n, 3)
        lb = geo.batched_origin_dist(diff, gjk_iters).lb
        ok = (lb > offset).reshape(idx.shape)
        return over | torch.any(sel_unc & ~ok, dim=(1, 2, 3))

    return graph.device_cond(sel_unc.any(), certify, lambda: over)
