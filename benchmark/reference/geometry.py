"""Convex collision geometry: exact simplex GJK, Frank-Wolfe GJK, the
robot-pair plane offset, the barrier-optimal plane refinements of
``optimal_plane=True`` and the k-DOP axes.

Port of the parts of `trajopt_tpu/ops/geometry.py` that the single- and
multi-robot solves run.  The refinements (`refine_plane`,
`refine_pair_plane`) are batched over a leading axis and take their 2x2
Newton systems in closed form where the reference differentiates the
energy with autodiff.  `origin_simplex_dist` is the plain version of
kernel K2 and `gjk_fw_plain` that of kernel K5 (`ops/cuda_gjk.py`);
`batched_origin_dist` is the solver's entry point and goes through K2's
wrapper.

Conservativeness (as in the reference): ``lb = min_i u_i . v / |v|`` is a
certified lower bound on the distance at every iteration and ``dist`` an
upper bound; safety decisions use ``lb``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS = 1e-12
_FEAS_TOL = 1e-6
_ALL_SUBSETS = [tuple(i for i in range(4) if (s >> i) & 1) for s in range(1, 16)]


class HullDist(NamedTuple):
    dist: torch.Tensor  # upper bound == |v| (converges to exact)
    lb: torch.Tensor    # certified lower bound (<= true distance)
    v: torch.Tensor     # [..., 3] vector from the query point to the closest hull point


def _det4_cols(a):
    """4x4 determinant by Laplace expansion along the first two rows."""
    def m2(r0, r1, c0, c1):
        return a[r0][c0] * a[r1][c1] - a[r0][c1] * a[r1][c0]

    return (
        m2(0, 1, 0, 1) * m2(2, 3, 2, 3)
        - m2(0, 1, 0, 2) * m2(2, 3, 1, 3)
        + m2(0, 1, 0, 3) * m2(2, 3, 1, 2)
        + m2(0, 1, 1, 2) * m2(2, 3, 0, 3)
        - m2(0, 1, 1, 3) * m2(2, 3, 0, 2)
        + m2(0, 1, 2, 3) * m2(2, 3, 0, 1)
    )


def _subset_solve(subset, g):
    """Unnormalized barycentric solve x = adj(G_S) e for a static subset.

    Returns (xs, s): dict slot -> x, and s = sum(x).  Each subset size has
    its own minimal closed form (a padded 4x4 adjugate loses ~3 digits to
    cancellation on near-degenerate simplices)."""
    k = len(subset)
    if k == 1:
        (i,) = subset
        one = torch.ones_like(g[i][i])
        return {i: one}, one
    if k == 2:
        i, j = subset
        xi = g[j][j] - g[i][j]
        xj = g[i][i] - g[i][j]
        return {i: xi, j: xj}, xi + xj
    if k == 3:
        i, j, l = subset
        a_, b_, c_ = g[i][i], g[i][j], g[i][l]
        d_, e_ = g[j][j], g[j][l]
        f_ = g[l][l]
        adj11 = d_ * f_ - e_ * e_
        adj12 = c_ * e_ - b_ * f_
        adj13 = b_ * e_ - c_ * d_
        adj22 = a_ * f_ - c_ * c_
        adj23 = b_ * c_ - a_ * e_
        adj33 = a_ * d_ - b_ * b_
        xi = adj11 + adj12 + adj13
        xj = adj12 + adj22 + adj23
        xl = adj13 + adj23 + adj33
        return {i: xi, j: xj, l: xl}, xi + xj + xl
    xs = {}
    one = torch.ones_like(g[0][0])
    for col in range(4):
        a = [[(one if c == col else g[r][c]) for c in range(4)] for r in range(4)]
        xs[col] = _det4_cols(a)
    return xs, xs[0] + xs[1] + xs[2] + xs[3]


def _min_norm_simplex(w: torch.Tensor, active: torch.Tensor):
    """Min-norm point of conv(w[active]) for a batch: w [N,4,3], active [N,4].

    Enumerates all 15 subsets; each solves ``G_S lam = e, sum lam = 1``.
    Every accepted candidate is a point in the hull (an upper bound) and the
    subset carrying the true projection solves exactly, so the minimum over
    subsets is the exact projection even when degenerate subsets produce
    noise.  Returns (v [N,3], n2 [N], sub [N,4] bool).
    """
    gm = w @ w.transpose(-1, -2)
    g = [[gm[:, i, j] for j in range(4)] for i in range(4)]
    n = w.shape[0]
    best_n2 = w.new_full((n,), float("inf"))
    best_v = w.new_zeros((n, 3))
    best_sub = torch.zeros((n, 4), dtype=torch.bool, device=w.device)
    slots = torch.arange(4, device=w.device)
    for subset in _ALL_SUBSETS:
        xs, s = _subset_solve(subset, g)
        feas = s > 1e-12
        inv = 1.0 / torch.where(feas, s, 1.0)
        for i in subset:
            feas = feas & active[:, i]
        v = w.new_zeros((n, 3))
        tot = w.new_zeros((n,))
        for i in subset:
            lam = xs[i] * inv
            feas = feas & torch.isfinite(lam) & (lam >= -_FEAS_TOL)
            lam_pos = torch.clamp(lam, min=0.0)
            tot = tot + lam_pos
            v = v + lam_pos[:, None] * w[:, i]
        # degeneracy guard: affinely dependent subsets (collinear control
        # points of straight segments) give roundoff-noise coefficients that
        # pass the -tol test one by one but do not sum to 1; renormalizing
        # and flooring tot keeps v a genuine convex combination
        feas = feas & (tot > 0.5)
        v = v / torch.clamp(tot, min=0.5)[:, None]
        n2 = (v * v).sum(-1)
        score = torch.where(feas, n2, float("inf"))
        take = score < best_n2
        best_n2 = torch.where(take, score, best_n2)
        best_v = torch.where(take[:, None], v, best_v)
        in_sub = torch.stack([slots == i for i in subset]).any(0)
        best_sub = torch.where(take[:, None], in_sub, best_sub)
    return best_v, best_n2, best_sub


def origin_simplex_dist(u: torch.Tensor, iters: int = 12) -> HullDist:
    """Distance from the origin to conv(u) by simplex GJK, u [..., m, 3].

    Sound (lb <= true <= dist) at any iteration count; exact up to roundoff
    once the support loop has converged.
    """
    lead, m = u.shape[:-2], u.shape[-2]
    u = u.reshape(-1, m, 3)
    n = u.shape[0]
    rows = torch.arange(n, device=u.device)
    scale = torch.clamp(u.abs().amax(dim=(1, 2)), min=1e-30)
    us = u / scale[:, None, None]
    i0 = torch.argmin((us * us).sum(-1), dim=1)
    w = us[rows, i0][:, None, :].expand(n, 4, 3).clone()
    active = torch.zeros((n, 4), dtype=torch.bool, device=u.device)
    active[:, 0] = True
    tol = 100 * torch.finfo(u.dtype).eps
    lb_best = u.new_full((n,), -float("inf"))
    v_best = u.new_zeros((n, 3))
    n2_best = u.new_full((n,), float("inf"))
    done = torch.zeros(n, dtype=torch.bool, device=u.device)
    for _ in range(iters):
        v, n2, sub = _min_norm_simplex(w, active)
        better = n2 < n2_best
        v_best = torch.where(better[:, None], v, v_best)
        n2_best = torch.where(better, n2, n2_best)
        vn = torch.sqrt(torch.clamp(n2, min=_EPS))
        scores = (us @ v[:, :, None])[..., 0]                      # [N, m]
        lb_best = torch.maximum(lb_best, scores.amin(-1) / vn)
        s = torch.argmin(scores, dim=-1)
        us_s = us[rows, s]                                         # [N, 3]
        # stale: the support vertex is already an active slot (an f32-
        # degenerate face solve; iterating further would cycle)
        stale = (active & (w == us_s[:, None, :]).all(-1)).any(-1)
        done = (
            done
            | (scores[rows, s] >= n2 - tol * torch.clamp(n2, min=1.0))
            | sub.all(-1)
            | stale
        )
        free = torch.argmin(sub.to(torch.uint8), dim=-1)           # first inactive slot
        w_new = w.clone()
        w_new[rows, free] = us_s
        active_new = sub.clone()
        active_new[rows, free] = True
        w = torch.where(done[:, None, None], w, w_new)
        active = torch.where(done[:, None], active, active_new)
        # a finished problem recomputes the same values every iteration
        if bool(done.all()):
            break
    v, n2, _ = _min_norm_simplex(w, active)
    better = n2 < n2_best
    v = torch.where(better[:, None], v, v_best)
    n2 = torch.where(better, n2, n2_best)
    dist = torch.sqrt(torch.clamp(n2, min=0.0)) * scale
    lb = torch.minimum(lb_best * scale, dist)
    return HullDist(
        dist=dist.reshape(lead), lb=lb.reshape(lead), v=(v * scale[:, None]).reshape(lead + (3,))
    )


def point_hull_distance(verts: torch.Tensor, point: torch.Tensor, iters: int = 24) -> HullDist:
    """Distance from ``point`` [..., 3] to the hull of ``verts`` [..., m, 3]."""
    return origin_simplex_dist(verts - point[..., None, :], iters)


def minkowski_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Difference set of two hull batches: a [..., na, 3], b [..., nb, 3] ->
    [..., na*nb, 3], row i*nb + j = a_i - b_j (a witness points from B
    toward A)."""
    return (a[..., :, None, :] - b[..., None, :, :]).flatten(-3, -2)


def hull_hull_distance(verts_a: torch.Tensor, verts_b: torch.Tensor, iters: int = 24) -> HullDist:
    """Distance between two convex hulls via their Minkowski difference
    (exact simplex GJK), batched over leading axes."""
    return origin_simplex_dist(minkowski_diff(verts_a, verts_b), iters)


def gjk_fw_plain(u: torch.Tensor, iters: int = 24) -> HullDist:
    """Frank-Wolfe distance from the origin to conv(u[i]), u [N, m, 3]: the
    plain version of kernel K5 (`ops/cuda_gjk.py::gjk_diffset`), a batched
    port of the reference's `geometry.point_hull_distance_fw`.

    Starts at the first vertex of least norm; each round compares the FW
    step toward the first argmin vertex with the pairwise step from the
    first argmax vertex of the support (weight > 1e-10) and keeps the one
    with the smaller |w.u|^2.  ``lb`` is certified but loose near contact."""
    n, m, _ = u.shape
    rows = torch.arange(n, device=u.device)
    eye = torch.eye(m, dtype=u.dtype, device=u.device)
    w = eye[torch.argmin((u * u).sum(-1), dim=1)]                  # [N,m]
    lb_best = u.new_full((n,), -float("inf"))

    # elementwise sums, not matrix products: duplicate vertices must score
    # bit-identically so that ties go to the lowest index
    def hull_point(wc):
        return (wc[:, :, None] * u).sum(1)

    for _ in range(iters):
        v = hull_point(w)
        vn = torch.sqrt(torch.clamp((v * v).sum(-1), min=_EPS))
        scores = (u * v[:, None, :]).sum(-1)
        lb_best = torch.maximum(lb_best, scores.amin(-1) / vn)
        s = torch.argmin(scores, dim=1)
        us = u[rows, s]
        d_fw = us - v
        g_fw = torch.clamp(-(v * d_fw).sum(-1) / torch.clamp((d_fw * d_fw).sum(-1), min=_EPS),
                           0.0, 1.0)
        w_fw = w + g_fw[:, None] * (eye[s] - w)
        a = torch.argmax(torch.where(w > 1e-10, scores, -float("inf")), dim=1)
        d_pw = us - u[rows, a]
        g_pw = torch.clamp(-(v * d_pw).sum(-1) / torch.clamp((d_pw * d_pw).sum(-1), min=_EPS),
                           min=0.0)
        g_pw = torch.minimum(g_pw, w[rows, a])
        w_pw = w + g_pw[:, None] * (eye[s] - eye[a])
        f_fw = (hull_point(w_fw) ** 2).sum(-1)
        f_pw = (hull_point(w_pw) ** 2).sum(-1)
        w = torch.where((f_pw < f_fw)[:, None], w_pw, w_fw)
    v = hull_point(w)
    dist = torch.sqrt(torch.clamp((v * v).sum(-1), min=0.0))
    return HullDist(dist=dist, lb=torch.minimum(lb_best, dist), v=v)


def check_gjk_route(cfg, device: torch.device) -> None:
    """On the card GJK always runs kernel K2: there is no plain path for CUDA
    tensors, so ``use_pallas_gjk=False`` (which selects the plain path in the
    JAX package) is refused there.  It has no effect on the CPU."""
    if torch.device(device).type == "cuda" and cfg.use_pallas_gjk is False:
        raise ValueError(
            "use_pallas_gjk=False: the torch port runs GJK on CUDA only through "
            "its kernel; leave use_pallas_gjk at None or True"
        )


def batched_origin_dist(diffsets: torch.Tensor, iters: int) -> HullDist:
    """Distance from the origin to conv(diffsets[i]) for a flat batch
    [N, m, 3], exact simplex GJK with min(iters, 16) iterations (K2)."""
    from . import kernels as cuda_gjk

    return cuda_gjk.gjk_exact(diffsets.contiguous(), min(iters, 16))


def optimal_d(hull_a, hull_b, c, d, offset: float, margin: float, iters: int) -> torch.Tensor:
    """Batched `geometry._optimal_d` of the reference: damped 1-D Newton on
    the symmetric two-sided barrier in the plane offset ``d`` [B] between
    hulls [B, n, 3] along unit normals ``c`` [B, 3], each step halved up to
    four times to keep both sides strictly feasible; an infeasible start
    returns ``d`` unchanged."""
    from .gradients import _barrier_d12

    da = torch.einsum("bnd,bd->bn", hull_a, c)
    db = torch.einsum("bnd,bd->bn", hull_b, c)

    def sides(dv):
        return da + dv[:, None] - 0.5 * offset, -db - dv[:, None] - 0.5 * offset

    def feasible(dv):
        dist_a, dist_b = sides(dv)
        return (dist_a.amin(-1) > 0) & (dist_b.amin(-1) > 0)

    def derivs(dist):
        return _barrier_d12(dist, margin, (dist > 0) & (dist < margin))

    dv = d
    for _ in range(iters):
        dist_a, dist_b = sides(dv)
        (ga, ha), (gb, hb) = derivs(dist_a), derivs(dist_b)
        g = ga.sum(-1) - gb.sum(-1)
        h = ha.sum(-1) + hb.sum(-1)
        step = -g / torch.clamp(h, min=1e-8)
        for _ in range(4):
            step = torch.where(feasible(dv + step), step, 0.5 * step)
        dv = torch.where(feasible(dv + step), dv + step, dv)
    return torch.where(feasible(d), dv, d)


def _side_energy(dist: torch.Tensor, margin: float) -> torch.Tensor:
    """Barrier energy of one side's signed distances [..., n] -> [...]: the
    clamped log barrier inside the band plus the reference's smooth penalty
    ``1e3 (margin - dist)^2`` on infeasible points."""
    act = (dist > 0) & (dist < margin)
    ds = torch.where(act, dist, margin)
    e = torch.where(act, -((ds - margin) ** 2) * torch.log(ds / margin), 0.0)
    e_bad = torch.where(dist <= 0, (margin - dist) ** 2 * 1e3, 0.0)
    return (e + e_bad).sum(-1)


def _side_derivs(dist: torch.Tensor, margin: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise first and second derivatives of `_side_energy`'s terms."""
    from .gradients import _barrier_d12

    e1, e2 = _barrier_d12(dist, margin, (dist > 0) & (dist < margin))
    bad = dist <= 0
    return (torch.where(bad, -2e3 * (margin - dist), e1),
            torch.where(bad, torch.full_like(dist, 2e3), e2))


def _rotation_frame(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tangent frame (c0, c1) of unit normals c [B,3]: c0 = (c_y, -c_x, 0)
    normalized (the x axis when c ~ +-z), c1 = c0 x c."""
    c0 = torch.stack([c[:, 1], -c[:, 0], torch.zeros_like(c[:, 0])], dim=-1)
    n0 = torch.sqrt(torch.clamp((c0 * c0).sum(-1), min=_EPS))
    x_axis = torch.zeros_like(c)
    x_axis[:, 0] = 1.0
    c0 = torch.where((n0 > 1e-6)[:, None], c0 / n0[:, None], x_axis)
    c1 = torch.linalg.cross(c0, c, dim=-1)
    c1 = c1 / torch.sqrt(torch.clamp((c1 * c1).sum(-1), min=_EPS))[:, None]
    return c0, c1


def _rotate(c, c0, c1, th, ph):
    """cos(th) c + sin(th) (cos(ph) c0 + sin(ph) c1), th/ph [B, L] -> [B, L, 3]."""
    th, ph = th[..., None], ph[..., None]
    return (torch.cos(th) * c[:, None]
            + torch.sin(th) * (torch.cos(ph) * c0[:, None] + torch.sin(ph) * c1[:, None]))


def _rotation_step(c, grad_e, hess_e, energy, ladder: int):
    """One damped Newton step on the energy of a unit normal in local
    rotation coordinates (theta, phi), batched over [B].

    ``grad_e`` [B,3] and ``hess_e`` [B,3,3] are the energy's derivatives in
    c; ``energy(cv [B,L,3]) -> [B,L]``.  At (theta, phi) = 0 the rotation
    has dc/dtheta = c0, dc/dphi = 0, d2c/dtheta2 = -c, d2c/dtheta dphi = c1
    and d2c/dphi2 = 0, so the local gradient is [grad.c0, 0] and the
    Hessian [[c0' H c0 - grad.c, grad.c1], [grad.c1, 0]] (+ 1e-2 I), the
    values the reference's autodiff gives.  The Armijo ladder step0 * 0.8^k
    (step0 clamps the largest angle below pi/2) takes its first accepted
    rung, the last one unconditionally.  Returns (trial normal [B,3], e0
    [B], w [B]) with w = -g.direction."""
    c0, c1 = _rotation_frame(c)
    g0 = (grad_e * c0).sum(-1)
    h00 = torch.einsum("bi,bij,bj->b", c0, hess_e, c0) - (grad_e * c).sum(-1) + 1e-2
    h01 = (grad_e * c1).sum(-1)
    h11 = 1e-2
    det = h00 * h11 - h01 * h01
    det = torch.where(det.abs() > _EPS, det, 1.0)
    d0 = -(h11 / det * g0)
    d1 = -(-h01 / det * g0)
    big = torch.maximum(d0.abs(), d1.abs())
    step0 = torch.where(big > 0.5 * np.pi, 0.95 * 0.5 * np.pi / big, 1.0)
    rungs = 0.8 ** torch.arange(ladder, dtype=c.dtype, device=c.device)
    steps = step0[:, None] * rungs                                  # [B,L]
    w = -(g0 * d0)
    e0 = energy(c[:, None])[:, 0]
    es = energy(_rotate(c, c0, c1, steps * d0[:, None], steps * d1[:, None]))
    ok = e0[:, None] - 1e-4 * w[:, None] * steps >= es
    ok[:, -1] = True
    s = steps.gather(1, torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True))   # [B,1]
    cc = _rotate(c, c0, c1, s * d0[:, None], s * d1[:, None])[:, 0]
    cc = cc / torch.sqrt(torch.clamp((cc * cc).sum(-1), min=_EPS))[:, None]
    return cc, e0, w


def refine_plane(hull, point, c, offset: float, margin: float, iters: int = 8,
                 ladder: int = 12) -> tuple[torch.Tensor, torch.Tensor]:
    """Barrier-optimal obstacle plane refinement (`Optimal_plane::optimal_cd`,
    Optimal_plane.h:160-293), batched: hulls [B,n,3], obstacle points [B,3],
    unit normals c [B,3].  Damped Newton on the hull-side barrier energy in
    the rotation coordinates of the normal (`_rotation_step`), ``d``
    eliminated as ``-c.point - offset``; a step is kept only if it lowers
    the energy along a descent direction.  Fixed counts: ``iters`` Newton
    steps of a ``ladder``-rung line search.  Returns (c [B,3], d [B])."""
    def dists(cv):                                                  # cv [B,L,3]
        return (torch.einsum("bnd,bld->bln", hull, cv)
                - torch.einsum("bld,bd->bl", cv, point)[..., None] - offset)

    def energy(cv):
        return _side_energy(dists(cv), margin)

    arm = hull - point[:, None]                                     # d dist / dc
    for _ in range(iters):
        e1, e2 = _side_derivs(dists(c[:, None])[:, 0], margin)      # [B,n]
        grad_e = torch.einsum("bn,bnd->bd", e1, arm)
        hess_e = torch.einsum("bn,bnd,bne->bde", e2, arm, arm)
        cc, e0, w = _rotation_step(c, grad_e, hess_e, energy, ladder)
        better = (energy(cc[:, None])[:, 0] <= e0) & (w > 0)
        c = torch.where(better[:, None], cc, c)
    return c, -(c * point).sum(-1) - offset


def refine_pair_plane(hull_a, hull_b, c, d, offset: float, margin: float, iters: int = 6,
                      ladder: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Barrier-optimal robot-pair plane refinement
    (`Optimal_plane::self_optimal_cd`, Optimal_plane.h:620-773), batched:
    hulls [B,n,3] on the positive (A) and negative (B) side, unit normals c
    [B,3], midplane offsets d [B].  Damped Newton on the symmetric two-sided
    barrier in the rotation coordinates of the normal at fixed ``d``; each
    trial normal then re-optimizes ``d`` from the support midpoint by four
    steps of `optimal_d`, and is kept only if that lowers the energy along a
    descent direction.  Returns (c [B,3], d [B])."""
    def dists(cv, dv):                                              # cv [B,L,3], dv [B]
        da = torch.einsum("bnd,bld->bln", hull_a, cv) + dv[:, None, None] - 0.5 * offset
        db = -torch.einsum("bnd,bld->bln", hull_b, cv) - dv[:, None, None] - 0.5 * offset
        return da, db

    def energy(cv, dv):
        da, db = dists(cv, dv)
        return _side_energy(da, margin) + _side_energy(db, margin)

    for _ in range(iters):
        da, db = dists(c[:, None], d)
        (a1, a2), (b1, b2) = _side_derivs(da[:, 0], margin), _side_derivs(db[:, 0], margin)
        grad_e = (torch.einsum("bn,bnd->bd", a1, hull_a)
                  - torch.einsum("bn,bnd->bd", b1, hull_b))
        hess_e = (torch.einsum("bn,bnd,bne->bde", a2, hull_a, hull_a)
                  + torch.einsum("bn,bnd,bne->bde", b2, hull_b, hull_b))
        cc, e0, w = _rotation_step(c, grad_e, hess_e, lambda cv: energy(cv, d), ladder)
        mid = 0.5 * ((-torch.einsum("bnd,bd->bn", hull_b, cc)).amin(-1)
                     + (-torch.einsum("bnd,bd->bn", hull_a, cc)).amax(-1))
        d_new = optimal_d(hull_a, hull_b, cc, mid, offset, margin, 4)
        better = (energy(cc[:, None], d_new)[:, 0] <= e0) & (w > 0)
        c = torch.where(better[:, None], cc, c)
        d = torch.where(better, d_new, d)
    return c, d


def kdop_axes() -> np.ndarray:
    """The reference's 49 normalized k-DOP directions (CCDUtils.cpp:56-119)."""
    base = [
        (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 1, 1), (1, -1, 1), (1, 1, -1), (1, -1, -1),
        (0, 1, 1), (0, 1, -1), (1, 0, 1), (1, 0, -1), (1, 1, 0), (1, -1, 0),
        (0, 2, 1), (0, 2, -1), (0, 1, 2), (0, 1, -2),
        (2, 0, 1), (2, 0, -1), (1, 0, 2), (1, 0, -2),
        (2, 1, 0), (2, -1, 0), (1, 2, 0), (1, -2, 0),
        (1, 2, 1), (1, 2, -1), (1, -2, 1), (-1, 2, 1),
        (1, 1, 2), (1, 1, -2), (1, -1, 2), (-1, 1, 2),
        (2, 1, 1), (2, 1, -1), (2, -1, 1), (-2, 1, 1),
        (2, 2, 1), (2, 2, -1), (2, -2, 1), (-2, 2, 1),
        (2, 1, 2), (2, 1, -2), (2, -1, 2), (-2, 1, 2),
        (1, 2, 2), (1, 2, -2), (1, -2, 2), (-1, 2, 2),
    ]
    a = np.asarray(base, dtype=np.float64)
    return a / np.linalg.norm(a, axis=1, keepdims=True)
