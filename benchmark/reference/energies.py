"""Augmented-Lagrangian energies as masked torch expressions.

Port of `trajopt_tpu/ops/energies.py`.  Every barrier term over (piece,
subdivision, plane slot, hull point) is a dense masked tensor expression;
infeasibility is a separate flag instead of an IEEE inf so that the
differentiated energies stay NaN-free.  `torch.where` evaluates both
branches, so the double-`where` patterns (`_barrier`, `_safe_norm`) are
kept exactly.

Barrier: ``b(d) = -(d - margin)^2 * log(d / margin)`` for ``0 < d < margin``,
0 for ``d >= margin``, infeasible for ``d <= 0``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import TrajOptConfig
from .types import Planes, SolverState, SplineConsts


class EnergyVal(NamedTuple):
    value: torch.Tensor       # scalar; valid only where ``infeasible`` is False
    infeasible: torch.Tensor  # scalar bool


def piece_cps(consts: SplineConsts, spline: torch.Tensor) -> torch.Tensor:
    """Stored rows per piece: [..., T, 3] -> [..., P, n, 3]."""
    return spline[..., consts.piece_idx, :]


def seg_cps(consts: SplineConsts, spline: torch.Tensor) -> torch.Tensor:
    """Control hulls of every subdivided segment: [..., T, 3] -> [..., P, R, n, 3]."""
    return torch.einsum("prij,...pjd->...prid", consts.seg_basis, piece_cps(consts, spline))


def _barrier(d: torch.Tensor, margin: float, active: torch.Tensor) -> torch.Tensor:
    """Masked barrier values; ``active`` must imply ``d > 0``."""
    d_safe = torch.where(active, d, margin)
    return torch.where(active, -((d_safe - margin) ** 2) * torch.log(d_safe / margin), 0.0)


def plane_distances(hull: torch.Tensor, planes: Planes) -> torch.Tensor:
    """Signed distances of hull CPs to planes: hull [P,R,n,3] -> [P,R,K,n]."""
    return torch.einsum("prjd,prkd->prkj", hull, planes.c) + planes.d[..., None]


def plane_barrier_energy(
    consts: SplineConsts, cfg: TrajOptConfig, spline: torch.Tensor, planes: Planes
) -> EnergyVal:
    hull = seg_cps(consts, spline)
    d = plane_distances(hull, planes)                      # [P,R,K,n]
    live = planes.mask[..., None]
    infeasible = torch.any(live & (d <= 0))
    active = live & (d > 0) & (d < cfg.margin)
    w = consts.seg_weight[None, :, None, None]
    e = torch.sum(w * _barrier(d, cfg.margin, active))
    return EnergyVal(e, infeasible)


def _safe_norm(vec: torch.Tensor, active_hint: torch.Tensor) -> torch.Tensor:
    """Norm along the last axis whose gradient is NaN-free on inactive entries
    (which include exactly-zero vectors, e.g. pinned duplicate end CPs)."""
    sq = torch.sum(vec * vec, dim=-1)
    sq_safe = torch.where(active_hint, sq, 1.0)
    return torch.where(active_hint, torch.sqrt(sq_safe), 0.0)


def bound_energy(
    consts: SplineConsts, cfg: TrajOptConfig, spline: torch.Tensor, piece_time: torch.Tensor
) -> EnergyVal:
    """Velocity/acceleration limit barrier on subdivided control polygons."""
    hull = seg_cps(consts, spline)                         # [P,R,n,3]
    n = consts.order
    w = consts.seg_weight[None, :, None]                   # [1,R,1]

    vel = n * torch.diff(hull, dim=2)
    vnorm = torch.sqrt(torch.sum(vel * vel, dim=-1))
    dv = cfg.vel_limit - vnorm / (w * piece_time)
    v_inf = torch.any(dv <= 0)
    v_act = (dv > 0) & (dv < cfg.margin)
    vn_safe = _safe_norm(vel, v_act)
    dv_safe = cfg.vel_limit - vn_safe / (w * piece_time)
    e_v = torch.sum(w * _barrier(dv_safe, cfg.margin, v_act))

    acc = n * (n - 1) * torch.diff(hull, n=2, dim=2)
    anorm = torch.sqrt(torch.sum(acc * acc, dim=-1))
    da = cfg.acc_limit - anorm / (w * w * piece_time * piece_time)
    a_inf = torch.any(da <= 0)
    a_act = (da > 0) & (da < cfg.margin)
    an_safe = _safe_norm(acc, a_act)
    da_safe = cfg.acc_limit - an_safe / (w * w * piece_time * piece_time)
    e_a = torch.sum(w * _barrier(da_safe, cfg.margin, a_act))
    return EnergyVal(e_v + e_a, v_inf | a_inf)


def dynamic_energy(
    consts: SplineConsts, cfg: TrajOptConfig, p_part: torch.Tensor, t_part: torch.Tensor
) -> torch.Tensor:
    """Jerk + time cost for one piece's true Bezier CPs (p_part [..., n, 3])."""
    quad = torch.einsum("...id,ij,...jd->...", p_part, consts.m_dyn, p_part)
    smooth = cfg.ks / t_part ** (2 * cfg.der - 1) * 0.5 * quad
    return smooth + cfg.kt * t_part ** 1.1


def consensus_terms(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    spline: torch.Tensor,
    piece_time: torch.Tensor,
    p_slack: torch.Tensor,
    t_slack: torch.Tensor,
    p_lambda: torch.Tensor,
    t_lambda: torch.Tensor,
) -> torch.Tensor:
    """Spline-side AL coupling terms, summed over pieces."""
    c_spline = torch.einsum("pij,pjd->pid", consts.convert, piece_cps(consts, spline))
    p_delta = c_spline - p_slack
    t_delta = piece_time - t_slack
    return (
        cfg.mu / 2.0 * torch.sum(p_delta * p_delta)
        + torch.sum(p_lambda * p_delta)
        + cfg.mu / 2.0 * torch.sum(t_delta * t_delta)
        + torch.sum(t_lambda * t_delta)
    )


def spline_energy(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,
    planes: Planes,
    spline: torch.Tensor | None = None,
    piece_time: torch.Tensor | None = None,
) -> EnergyVal:
    """lam*(plane barrier + bound barrier) + AL terms, at the state's spline
    or at an overriding trial point."""
    spline = state.spline if spline is None else spline
    piece_time = state.piece_time if piece_time is None else piece_time
    pb = plane_barrier_energy(consts, cfg, spline, planes)
    bd = bound_energy(consts, cfg, spline, piece_time)
    al = consensus_terms(
        consts, cfg, spline, piece_time,
        state.p_slack, state.t_slack, state.p_lambda, state.t_lambda,
    )
    return EnergyVal(cfg.lam * (pb.value + bd.value) + al, pb.infeasible | bd.infeasible)


def slack_energy(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    c_spline: torch.Tensor,   # [P,n,3] converted spline CPs (constant here)
    piece_time: torch.Tensor,
    p_part: torch.Tensor,     # [P,n,3] slack variables
    t_part: torch.Tensor,     # [P]
    p_lambda: torch.Tensor,
    t_lambda: torch.Tensor,
) -> torch.Tensor:
    """Per-piece slack-subproblem energies, [P]."""
    quad = torch.einsum("pid,ij,pjd->p", p_part, consts.m_dyn, p_part)
    dyn = cfg.ks / t_part ** (2 * cfg.der - 1) * 0.5 * quad + cfg.kt * t_part ** 1.1
    delta = c_spline - p_part
    t_delta = piece_time - t_part
    return (
        dyn
        + cfg.mu / 2.0 * torch.sum(delta * delta, dim=(1, 2))
        + torch.sum(p_lambda * delta, dim=(1, 2))
        + cfg.mu / 2.0 * t_delta * t_delta
        + t_lambda * t_delta
    )


def true_objective(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    spline: torch.Tensor,
    piece_time: torch.Tensor,
    planes: Planes,
) -> dict:
    """Diagnostic decomposition of the non-AL objective."""
    c_spline = torch.einsum("pij,pjd->pid", consts.convert, piece_cps(consts, spline))
    quad = torch.einsum("pid,ij,pjd->", c_spline, consts.m_dyn, c_spline)
    smooth = cfg.ks / piece_time ** (2 * cfg.der - 1) * 0.5 * quad
    pb = plane_barrier_energy(consts, cfg, spline, planes)
    bd = bound_energy(consts, cfg, spline, piece_time)
    return {
        "smooth": smooth,
        "barrier": cfg.lam * pb.value,
        "bound": cfg.lam * bd.value,
        "time": cfg.kt * consts.whole_weight * piece_time,
        "infeasible": pb.infeasible | bd.infeasible,
    }


class TrialTables(NamedTuple):
    """Per-iteration tables that make every line-search energy evaluation an
    elementwise pass: everything inside `spline_energy` is affine in the
    trial step s, and the AL terms are the quadratic a0 + a1 s + a2 s^2.
    All leaves carry a leading robot axis U."""

    d0: torch.Tensor      # [U,P,R,K,n] plane distances at s=0
    dd: torch.Tensor      # [U,P,R,K,n] their derivative in s
    live: torch.Tensor    # [U,P,R,K,1]
    vel0: torch.Tensor    # [U,P,R,n-1,3]
    dvel: torch.Tensor
    acc0: torch.Tensor    # [U,P,R,n-2,3]
    dacc: torch.Tensor
    t0: torch.Tensor      # [U]
    dt: torch.Tensor      # [U]
    a0: torch.Tensor      # [U] AL quadratic coefficients
    a1: torch.Tensor
    a2: torch.Tensor


def build_trial_tables(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,          # leaves [U,...]
    planes: Planes,              # [U,P,R,K,...]
    directions: torch.Tensor,    # [U,T,3]
    dt: torch.Tensor,            # [U]
) -> TrialTables:
    idx = consts.piece_idx
    hull0 = torch.einsum("prij,upjd->uprid", consts.seg_basis, state.spline[:, idx])
    dhull = torch.einsum("prij,upjd->uprid", consts.seg_basis, directions[:, idx])
    d0 = torch.einsum("uprjd,uprkd->uprkj", hull0, planes.c) + planes.d[..., None]
    dd = torch.einsum("uprjd,uprkd->uprkj", dhull, planes.c)
    n = consts.order
    vel0 = n * torch.diff(hull0, dim=3)
    dvel = n * torch.diff(dhull, dim=3)
    acc0 = n * (n - 1) * torch.diff(hull0, n=2, dim=3)
    dacc = n * (n - 1) * torch.diff(dhull, n=2, dim=3)

    c0 = torch.einsum("pij,upjd->upid", consts.convert, state.spline[:, idx])
    cd = torch.einsum("pij,upjd->upid", consts.convert, directions[:, idx])
    d0_ = c0 - state.p_slack
    td0 = state.piece_time[:, None] - state.t_slack         # [U,P]
    a0 = (
        cfg.mu / 2.0 * torch.sum(d0_ * d0_, dim=(1, 2, 3))
        + torch.sum(state.p_lambda * d0_, dim=(1, 2, 3))
        + cfg.mu / 2.0 * torch.sum(td0 * td0, dim=1)
        + torch.sum(state.t_lambda * td0, dim=1)
    )
    a1 = (
        cfg.mu * torch.sum(d0_ * cd, dim=(1, 2, 3))
        + torch.sum(state.p_lambda * cd, dim=(1, 2, 3))
        + cfg.mu * torch.sum(td0, dim=1) * dt
        + torch.sum(state.t_lambda, dim=1) * dt
    )
    p_num = state.t_slack.shape[1]
    a2 = cfg.mu / 2.0 * torch.sum(cd * cd, dim=(1, 2, 3)) + cfg.mu / 2.0 * p_num * dt ** 2
    return TrialTables(
        d0=d0, dd=dd, live=planes.mask[..., None],
        vel0=vel0, dvel=dvel, acc0=acc0, dacc=dacc,
        t0=state.piece_time, dt=dt, a0=a0, a1=a1, a2=a2,
    )


def trial_energy(
    consts: SplineConsts, cfg: TrajOptConfig, tt: TrialTables, s: torch.Tensor
) -> torch.Tensor:
    """[U] spline AL energies at per-robot steps ``s`` ([U] or scalar), +inf
    where infeasible: `spline_energy` at spline + s*direction up to
    reassociation (d0 + s*dd instead of (hull0 + s*dhull).c)."""
    if not torch.is_tensor(s):
        s = torch.tensor(s, dtype=tt.t0.dtype, device=tt.t0.device)
    s = torch.broadcast_to(s, tt.t0.shape)
    su = s[:, None, None, None, None]
    d = tt.d0 + su * tt.dd
    live = tt.live
    bad = torch.any(live & (d <= 0), dim=(1, 2, 3, 4))
    act = live & (d > 0) & (d < cfg.margin)
    w = consts.seg_weight[None, None, :, None, None]
    e_pb = torch.sum(w * _barrier(d, cfg.margin, act), dim=(1, 2, 3, 4))

    t = tt.t0 + s * tt.dt
    w3 = consts.seg_weight[None, None, :, None]
    vel = tt.vel0 + su * tt.dvel
    vn = torch.sqrt(torch.clamp(torch.sum(vel * vel, dim=-1), min=1e-30))
    dv = cfg.vel_limit - vn / (w3 * t[:, None, None, None])
    bad = bad | torch.any(dv <= 0, dim=(1, 2, 3))
    v_act = (dv > 0) & (dv < cfg.margin)
    e_bd = torch.sum(w3 * _barrier(dv, cfg.margin, v_act), dim=(1, 2, 3))
    acc = tt.acc0 + su * tt.dacc
    an = torch.sqrt(torch.clamp(torch.sum(acc * acc, dim=-1), min=1e-30))
    da = cfg.acc_limit - an / (w3 * w3 * (t * t)[:, None, None, None])
    bad = bad | torch.any(da <= 0, dim=(1, 2, 3))
    a_act = (da > 0) & (da < cfg.margin)
    e_bd = e_bd + torch.sum(w3 * _barrier(da, cfg.margin, a_act), dim=(1, 2, 3))

    al = tt.a0 + tt.a1 * s + tt.a2 * s * s
    e = cfg.lam * (e_pb + e_bd) + al
    return torch.where(bad | torch.isnan(e), float("inf"), e)
