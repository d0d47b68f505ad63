"""Per-piece Newton blocks: local AL energies, their gradients and Hessians,
and the batched PSD repair.

Port of `trajopt_tpu/ops/gradients.py`.  Each piece's 19 local variables
(18 control-point coordinates + 1 time) get a closed-form gradient/Hessian
(`analytic_spline_gh`, the default) or an autodiff one
(``torch.func.vmap(jacfwd(grad))``, ``grad_mode="autodiff"``).  PSD repair
is the GMW modified Cholesky (kernel K3 on the card, the default), the
reference's eigenvalue shift (``psd_method="eigh"``, kernel K6) or the
Cholesky shift ladder (``psd_method="ladder"``, K3's plain mode).  None of
them reads anything back to the host, so every driver, the fused ones
included, takes each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, jacfwd, vmap

from .config import TrajOptConfig
from .types import Planes, SplineConsts
from . import kernels as cuda_chol
from . import kernels as cuda_eig
from . import energies as en

N_CP = 6        # order + 1
N_LOC = 19      # 18 CP coords + shared time


class PieceData(NamedTuple):
    """Per-piece slices of constants and ADMM state (leading axis P)."""

    seg_basis: torch.Tensor   # [R, n, n]
    seg_weight: torch.Tensor  # [R]
    convert: torch.Tensor     # [n, n]
    plane_c: torch.Tensor     # [R, K, 3]
    plane_d: torch.Tensor     # [R, K]
    plane_mask: torch.Tensor  # [R, K]
    p_slack: torch.Tensor     # [n, 3]
    p_lambda: torch.Tensor    # [n, 3]
    t_slack: torch.Tensor     # []
    t_lambda: torch.Tensor    # []


def gather_piece_data(
    consts: SplineConsts,
    planes: Planes,
    p_slack: torch.Tensor,
    t_slack: torch.Tensor,
    p_lambda: torch.Tensor,
    t_lambda: torch.Tensor,
) -> PieceData:
    """Per-piece data with any leading robot axes folded into the piece
    axis (leaves [B*P, ...])."""
    p = consts.piece_num
    b = t_slack.numel() // p

    def rep(x):   # [P, ...] constants -> [B*P, ...]
        return x.expand((b,) + x.shape).reshape((b * p,) + x.shape[1:])

    def fold(x, tail):
        return x.reshape((b * p,) + x.shape[x.ndim - tail:])

    return PieceData(
        seg_basis=rep(consts.seg_basis),
        seg_weight=torch.broadcast_to(consts.seg_weight, (b * p, consts.res)),
        convert=rep(consts.convert),
        plane_c=fold(planes.c, 3),
        plane_d=fold(planes.d, 2),
        plane_mask=fold(planes.mask, 2),
        p_slack=fold(p_slack, 2),
        p_lambda=fold(p_lambda, 2),
        t_slack=t_slack.reshape(-1),
        t_lambda=t_lambda.reshape(-1),
    )


def local_spline_energy(x: torch.Tensor, data: PieceData, cfg: TrajOptConfig) -> torch.Tensor:
    """One piece's spline-subproblem AL energy over its 19 local variables.
    Masked, never infinite, so it is safely differentiable."""
    cp = x[: 3 * N_CP].reshape(N_CP, 3)
    piece_time = x[3 * N_CP]
    hull = torch.einsum("rij,jd->rid", data.seg_basis, cp)        # [R,n,3]
    w = data.seg_weight

    d = torch.einsum("rjd,rkd->rkj", hull, data.plane_c) + data.plane_d[..., None]
    act = data.plane_mask[..., None] & (d > 0) & (d < cfg.margin)
    e_pb = torch.sum(w[:, None, None] * en._barrier(d, cfg.margin, act))

    n = N_CP - 1
    vel = n * torch.diff(hull, dim=1)
    wv = w[:, None]
    vn_raw = torch.sqrt(torch.sum(vel * vel, dim=-1))
    dv_raw = cfg.vel_limit - vn_raw / (wv * piece_time)
    v_act = (dv_raw > 0) & (dv_raw < cfg.margin)
    vn = en._safe_norm(vel, v_act)
    dv = cfg.vel_limit - vn / (wv * piece_time)
    e_bd = torch.sum(wv * en._barrier(dv, cfg.margin, v_act))

    acc = n * (n - 1) * torch.diff(hull, n=2, dim=1)
    an_raw = torch.sqrt(torch.sum(acc * acc, dim=-1))
    da_raw = cfg.acc_limit - an_raw / (wv * wv * piece_time * piece_time)
    a_act = (da_raw > 0) & (da_raw < cfg.margin)
    an = en._safe_norm(acc, a_act)
    da = cfg.acc_limit - an / (wv * wv * piece_time * piece_time)
    e_bd = e_bd + torch.sum(wv * en._barrier(da, cfg.margin, a_act))

    delta = data.convert @ cp - data.p_slack
    t_delta = piece_time - data.t_slack
    (mu_half,) = _consts_like(x, cfg.mu / 2.0)
    al = (
        mu_half * torch.sum(delta * delta)
        + torch.sum(data.p_lambda * delta)
        + mu_half * t_delta * t_delta
        + data.t_lambda * t_delta
    )
    return cfg.lam * (e_pb + e_bd) + al


def local_slack_energy(
    x: torch.Tensor,
    c_spline: torch.Tensor,   # [n,3] converted spline CPs (constant)
    piece_time: torch.Tensor,
    p_lambda: torch.Tensor,
    t_lambda: torch.Tensor,
    m_dyn: torch.Tensor,
    cfg: TrajOptConfig,
) -> torch.Tensor:
    """One piece's slack-subproblem energy over its 19 local variables."""
    p_part = x[: 3 * N_CP].reshape(N_CP, 3)
    t_part = x[3 * N_CP]
    quad = torch.einsum("id,ij,jd->", p_part, m_dyn, p_part)
    ks, half, kt, mu_half = _consts_like(x, cfg.ks, 0.5, cfg.kt, cfg.mu / 2.0)
    dyn = ks / t_part ** (2 * cfg.der - 1) * half * quad + kt * t_part ** 1.1
    delta = c_spline - p_part
    t_delta = piece_time - t_part
    return (
        dyn
        + mu_half * torch.sum(delta * delta)
        + torch.sum(p_lambda * delta)
        + mu_half * t_delta * t_delta
        + t_lambda * t_delta
    )


def _consts_like(x: torch.Tensor, *values: float) -> tuple[torch.Tensor, ...]:
    """Python constants as 0-d tensors of ``x``'s dtype.  Under
    ``jacfwd(grad)`` a Python float times 0-d tensors can come out float64
    (the tangent loses the float's weak type), which turns a float32
    Hessian into float64."""
    return tuple(x.new_full((), v) for v in values)


def grad_and_hess(fn, x, *args):
    """Gradient and forward-over-reverse Hessian of a scalar function of x."""
    return grad(fn)(x, *args), jacfwd(grad(fn))(x, *args)


def _barrier_d12(d, margin, act):
    """Elementwise (b'(d), b''(d)) of the barrier, zero outside ``act``."""
    ds = torch.where(act, d, margin)
    ln = torch.log(ds / margin)
    dm = ds - margin
    b1 = -2.0 * dm * ln - dm * dm / ds
    b2 = -2.0 * ln - 4.0 * dm / ds + dm * dm / (ds * ds)
    zero = torch.zeros_like(ds)
    return torch.where(act, b1, zero), torch.where(act, b2, zero)


def analytic_spline_gh(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    xs: torch.Tensor,        # [P,19]
    data: PieceData,         # leaves with leading P
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form batched gradient/Hessian of `local_spline_energy`: every
    term is linear (plane distances, AL) or a norm of a linear map (vel/acc)
    in the 18 CP coordinates, so the exact Hessian is a few einsums."""
    p_num = xs.shape[0]
    n = N_CP - 1
    cp = xs[:, : 3 * N_CP].reshape(p_num, N_CP, 3)
    t = xs[:, 3 * N_CP]
    B = data.seg_basis                                    # [P,R,n_cp,n_cp]
    w = data.seg_weight                                   # [P,R]
    lam = cfg.lam
    eye3 = torch.eye(3, dtype=xs.dtype, device=xs.device)

    hull = torch.einsum("prji,pid->prjd", B, cp)
    d = torch.einsum("prjd,prkd->prkj", hull, data.plane_c) + data.plane_d[..., None]
    act = data.plane_mask[..., None] & (d > 0) & (d < cfg.margin)
    b1, b2 = _barrier_d12(d, cfg.margin, act)
    wk = w[:, :, None, None]
    e1 = lam * wk * b1
    e2 = lam * wk * b2
    c = data.plane_c
    g_cp = torch.einsum("prkj,prji,prkd->pid", e1, B, c)
    # contract the plane axis K first (fewer flops than the basis first)
    e_cc = torch.einsum("prkj,prkd,prke->prjde", e2, c, c)
    h_cp = torch.einsum("prji,prjq,prjde->pidqe", B, B, e_cc)

    def bound_terms(lin_basis, lin_val, s, f, g_tt, limit):
        """Shared vel/acc assembly: d = limit - |v|*s with ds/dt = -f*s/t and
        d2(|v|s)/dt2 = g_tt*|v|s/t^2 (f=1, g_tt=2 vel; f=2, g_tt=6 acc)."""
        vn_raw = torch.sqrt(torch.sum(lin_val * lin_val, dim=-1))   # [P,R,A]
        sv = s[:, :, None]
        dv_raw = limit - vn_raw * sv
        a_act = (dv_raw > 0) & (dv_raw < cfg.margin)
        vn = torch.where(a_act, torch.clamp(vn_raw, min=1e-30), 1.0)
        u = lin_val / vn[..., None]
        dv = limit - vn * sv
        b1, b2 = _barrier_d12(dv, cfg.margin, a_act)
        e1 = lam * w[:, :, None] * b1
        e2 = lam * w[:, :, None] * b2
        tt = t[:, None, None]
        g_cp = torch.einsum("pra,prad,prai->pid", -e1 * sv, u, lin_basis)
        g_t = torch.sum(e1 * f * vn * sv / tt, dim=(1, 2))
        # cp-cp block: e2 s^2 uu^T + e1 s/vn (uu^T - I)
        cA = e2 * sv * sv + e1 * sv / vn
        cB = -e1 * sv / vn
        pnum, rr, aa, ncp = lin_basis.shape
        m1 = torch.einsum("pra,prai,prad->praid", cA, lin_basis, u)
        m2 = torch.einsum("praq,prae->praqe", lin_basis, u)
        h_cp = torch.einsum(
            "prax,pray->pxy",
            m1.reshape(pnum, rr, aa, ncp * 3),
            m2.reshape(pnum, rr, aa, ncp * 3),
        ).reshape(pnum, ncp, 3, ncp, 3)
        h_cp = h_cp + torch.einsum("pra,prai,praq,de->pidqe", cB, lin_basis, lin_basis, eye3)
        cT = (-e2 * f * vn * sv * sv + e1 * f * sv) / tt
        h_cpt = torch.einsum("pra,prad,prai->pid", cT, u, lin_basis)
        h_tt = torch.sum(
            e2 * (f * vn * sv / tt) ** 2 - e1 * g_tt * vn * sv / (tt * tt), dim=(1, 2)
        )
        return g_cp, g_t, h_cp, h_cpt, h_tt

    vel_basis = n * (B[:, :, 1:, :] - B[:, :, :-1, :])
    vel = torch.einsum("prai,pid->prad", vel_basis, cp)
    s_v = 1.0 / (w * t[:, None])
    gv, gvt, hv, hvt, hvtt = bound_terms(vel_basis, vel, s_v, 1.0, 2.0, cfg.vel_limit)

    acc_basis = (n - 1) * (vel_basis[:, :, 1:, :] - vel_basis[:, :, :-1, :])
    acc = torch.einsum("prai,pid->prad", acc_basis, cp)
    s_a = 1.0 / (w * w * t[:, None] * t[:, None])
    ga, gat, ha, hat, hatt = bound_terms(acc_basis, acc, s_a, 2.0, 6.0, cfg.acc_limit)

    g_cp = g_cp + gv + ga
    g_t = gvt + gat
    h_cp = h_cp + hv + ha
    h_cpt = hvt + hat
    h_tt = hvtt + hatt

    delta = torch.einsum("pji,pid->pjd", data.convert, cp) - data.p_slack
    g_cp = g_cp + torch.einsum("pji,pjd->pid", data.convert, cfg.mu * delta + data.p_lambda)
    h_cp = h_cp + cfg.mu * torch.einsum("pji,pjq,de->pidqe", data.convert, data.convert, eye3)
    g_t = g_t + cfg.mu * (t - data.t_slack) + data.t_lambda
    h_tt = h_tt + cfg.mu

    k = 3 * N_CP
    g = torch.cat([g_cp.reshape(p_num, k), g_t[:, None]], dim=1)
    hct = h_cpt.reshape(p_num, k)
    top = torch.cat([h_cp.reshape(p_num, k, k), hct[:, :, None]], dim=2)
    bottom = torch.cat([hct, h_tt[:, None]], dim=1)[:, None, :]
    return g, torch.cat([top, bottom], dim=1)


def psd_repair_gmw(h: torch.Tensor) -> torch.Tensor:
    """PSD repair by GMW modified Cholesky (kernel K3 on the card): returns
    ``h + diag(e)`` with e >= 0, PD by construction, e == 0 on
    comfortably-PD blocks."""
    m = h.shape[-1]
    _, e = cuda_chol.mod_chol(h.contiguous(), want_l=False)
    return h + e[..., None] * torch.eye(m, dtype=h.dtype, device=h.device)


def piece_grads_and_hessians(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    spline: torch.Tensor,
    piece_time: torch.Tensor,
    planes: Planes,
    p_slack: torch.Tensor,
    t_slack: torch.Tensor,
    p_lambda: torch.Tensor,
    t_lambda: torch.Tensor,
    repair: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., P, 19] gradients and PSD-repaired [..., P, 19, 19] Hessians of
    the spline subproblem; leading robot axes of the state (``spline``
    [..., T, 3], ``piece_time`` [...]) fold into one batch of pieces."""
    p = consts.piece_num
    lead = spline.shape[:-2]
    cps = en.piece_cps(consts, spline)
    times = torch.broadcast_to(piece_time[..., None], lead + (p,))
    xs = torch.cat([cps.reshape(-1, 3 * N_CP), times.reshape(-1, 1)], dim=1)
    data = gather_piece_data(consts, planes, p_slack, t_slack, p_lambda, t_lambda)
    if cfg.grad_mode == "analytic":
        g, h = analytic_spline_gh(consts, cfg, xs, data)
    elif cfg.grad_mode == "autodiff":
        g, h = vmap(lambda x, d: grad_and_hess(local_spline_energy, x, d, cfg))(xs, data)
    else:
        raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")
    g = g.reshape(lead + (p, N_LOC))
    h = h.reshape(lead + (p, N_LOC, N_LOC))
    if not repair:
        return g, h
    return g, apply_psd_repair(cfg, h)


def psd_repair(h: torch.Tensor) -> torch.Tensor:
    """Batched spectrum shift: ``h + (0.01 - w_min) I`` where the least
    eigenvalue w_min is negative (the reference's repair on a failed
    Cholesky, Gradient_admm.h:44-53), the eigenvalues from K6 on the card.
    A block whose eigenvalues come out non-finite is shifted by its
    Gershgorin bound instead, which can only over-damp.  A block holding a
    non-finite entry goes to `cuda_eig.eigvalsh` as the identity and takes
    the Gershgorin bound, as its NaN eigenvalues do in the reference."""
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    finite = torch.isfinite(h).all(-1).all(-1)
    wmin = cuda_eig.eigvalsh(torch.where(finite[..., None, None], h, eye))[..., 0]
    diag = torch.diagonal(h, dim1=-2, dim2=-1)
    gersh = (diag - (h.abs().sum(-1) - diag.abs())).amin(-1)
    wmin = torch.where(finite & torch.isfinite(wmin), wmin, gersh)
    shift = torch.where(wmin < 0, -wmin + 0.01, 0.0)
    return h + shift[..., None, None] * eye


_LADDER_RUNGS = 13     # nonzero rungs spanning _LADDER_DECADES below Gershgorin
_LADDER_DECADES = 6.0  # G can overestimate -lambda_min by 1e4+ on real blocks
_LADDER_BISECT = 3     # geometric-bisection refinements of the bracketing rungs


def _chol_ok(mat: torch.Tensor) -> torch.Tensor:
    """[..., m, m] -> [...] bool: does the plain Cholesky factor of ``mat``
    have a finite, positive diagonal?  K3 in plain mode on the card (no
    host read, unlike `torch.linalg.cholesky_ex`), `smallchol.cholesky` on
    the CPU."""
    m = mat.shape[-1]
    l, _ = cuda_chol.mod_chol(mat.reshape(-1, m, m).contiguous(), gmw=False)
    ld = torch.diagonal(l, dim1=-2, dim2=-1).reshape(mat.shape[:-1])
    return torch.all(torch.isfinite(ld) & (ld > 0), dim=-1)


def psd_repair_ladder(h: torch.Tensor) -> torch.Tensor:
    """PSD repair by a parallel Cholesky shift ladder
    (`trajopt_tpu/ops/gradients.py::psd_repair_ladder`): factor ``h + s_j I``
    for 0 and 13 geometric rungs s_j spanning 6 decades below the Gershgorin
    bound G = max(-min_i(h_ii - sum_j!=i |h_ij|), 1e-30), all in one batched
    plain Cholesky (`_chol_ok`), take the smallest rung that factors, and
    refine it between its lower neighbour and itself by 3 geometric
    bisections, one batched Cholesky each.  PD blocks get shift 0; a block
    where no rung factors (H + G I numerically singular) takes 1.1 G; a
    positive shift gets the reference's +0.01 floor.  A block holding a NaN
    comes back unchanged."""
    m = h.shape[-1]
    eye = torch.eye(m, dtype=h.dtype, device=h.device)
    diag = torch.diagonal(h, dim1=-2, dim2=-1)
    offsum = torch.sum(torch.abs(h), dim=-1) - torch.abs(diag)
    gersh = torch.clamp(-torch.amin(diag - offsum, dim=-1), min=1e-30)     # >= -lambda_min
    ratio = 10.0 ** (_LADDER_DECADES / (_LADDER_RUNGS - 1))
    expo = torch.arange(1 - _LADDER_RUNGS, 1, dtype=h.dtype, device=h.device) * (
        _LADDER_DECADES / (_LADDER_RUNGS - 1))                              # -DECADES..0
    shifts = torch.cat([h.new_zeros(1), torch.pow(10.0, expo)]) * gersh[..., None]   # [..., S+1]
    ok = _chol_ok(h[..., None, :, :] + shifts[..., None, None] * eye)       # [..., S+1]
    # the smallest rung that factors; 0 where none does, as jnp.argmax of
    # an all-False row (torch.argmax takes no bool: first max of a 0/1 cast)
    first = torch.argmax(ok.to(torch.uint8), dim=-1)
    hi = torch.gather(shifts, -1, first[..., None])[..., 0]
    # measure-zero degeneracy: H + G*I numerically singular -> bump past bound
    hi = torch.where(torch.any(ok, dim=-1), hi, 1.1 * gersh)
    # refine within (hi/ratio, hi]; blocks settled at rung 0 or the floor
    # rung 1 are not refined
    refine = first > 1
    lo = hi / ratio
    for _ in range(_LADDER_BISECT):
        mid = torch.sqrt(lo * hi)
        mid_ok = _chol_ok(h + torch.where(refine, mid, gersh)[..., None, None] * eye)
        hi = torch.where(refine & mid_ok, mid, hi)
        lo = torch.where(refine & ~mid_ok, mid, lo)
    # zero shift iff rung 0 itself factored: on all-fail blocks first == 0
    # too, but ok[..., 0] is False there, so the 1.1 G bump is kept
    shift = torch.where(ok[..., 0], 0.0, hi)
    shift = torch.where(shift > 0, shift + 0.01, 0.0)                       # reference floor
    return h + shift[..., None, None] * eye


def apply_psd_repair(cfg: TrajOptConfig, h: torch.Tensor) -> torch.Tensor:
    """Dispatch on ``cfg.psd_method``: "gmw" (default), "eigh" or "ladder".
    Any other name raises `ValueError`, where the JAX package takes GMW for
    it in the direction and the ladder in the slack step."""
    if cfg.psd_method == "eigh":
        return psd_repair(h)
    if cfg.psd_method == "ladder":
        return psd_repair_ladder(h)
    if cfg.psd_method == "gmw":
        return psd_repair_gmw(h)
    raise ValueError(f"unknown psd_method {cfg.psd_method!r}; expected 'gmw', 'eigh' or 'ladder'")
