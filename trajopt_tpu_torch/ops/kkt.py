"""Reduced arrowhead KKT assembly and Schur-complement Newton solve.

Port of `trajopt_tpu/ops/kkt.py`.  The spline block A couples the free
control-point coordinates (block-banded: adjacent pieces share 3 stored
rows); one scalar time variable borders it:

    [A  b] [ds]   [gs]          s   = h_tt - b^T A^-1 b
    [b^T c] [dt] = -[gt]   =>   dt  = -(gt - b^T A^-1 gs) / s
                                ds  = -A^-1 gs - dt * A^-1 b

Systems with ns <= 64 factor and solve in one fused K3 + K4 launch and
refine with K4 (`ops/cuda_chol.py`); larger ones (P >= 8) use the
block-tridiagonal factorization below, its 18 x 18 diagonal blocks factored
by K3 in plain mode and its solves block by block with
`torch.linalg.solve_triangular`.  Neither syncs with the host nor calls the
Cholesky library routines (MAGMA behind `cholesky_solve` aborts under CUDA
graph capture), so the fused drivers can capture them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import SplineConsts
from . import cuda_chol
from .gradients import N_CP

# blocks at or below this size use the modified-Cholesky kernels
_UNROLL_MAX = 64

_BT_BLOCK = 18  # 6 stored rows x 3 coords: with 18-blocks A is block-tridiagonal


def _pad_blocks(a: torch.Tensor) -> tuple[torch.Tensor, int]:
    """[..., ns, ns] -> ([..., nb, k, nb, k] with an identity pad, nb)."""
    ns = a.shape[-1]
    nb = -(-ns // _BT_BLOCK)
    pad = nb * _BT_BLOCK - ns
    batch = a.shape[:-2]
    if pad:
        eye_pad = torch.eye(ns + pad, dtype=a.dtype, device=a.device)[ns:]
        a = torch.cat(
            [torch.cat([a, a.new_zeros(batch + (ns, pad))], -1),
             torch.broadcast_to(eye_pad, batch + (pad, ns + pad))],
            -2,
        )
    return a.reshape(batch + (nb, _BT_BLOCK, nb, _BT_BLOCK)), nb


def _factor_block_tridiag(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of the block-banded spline KKT, one 18x18 block step at a
    time (L is block-bidiagonal; the JAX package's `lax.scan`).  Returns the
    dense [..., ns, ns] lower factor; a non-PD block gives NaNs, as the JAX
    factorization does: K3's plain mode (``gmw=False``) takes the square
    root of a non-positive pivot, and the block's lower triangle is then
    NaN (the NaNs of `jnp.linalg.cholesky`)."""
    ns = a.shape[-1]
    blocks, nb = _pad_blocks(a)
    batch, k = a.shape[:-2], _BT_BLOCK
    full = a.new_zeros(batch + (nb, k, nb, k))
    nan_block = torch.full((k, k), float("nan"), dtype=a.dtype, device=a.device).tril()
    l_prev = None
    for b in range(nb):
        d_b = blocks[..., b, :, b, :]
        if b:
            e_b = blocks[..., b, :, b - 1, :]
            # X_b = E_b L_{b-1}^{-T}  (solve L_{b-1} X^T = E^T)
            x = torch.linalg.solve_triangular(l_prev, e_b.transpose(-1, -2), upper=False)
            x = x.transpose(-1, -2)
            full[..., b, :, b - 1, :] = x
            d_b = d_b - x @ x.transpose(-1, -2)
        l_b = cuda_chol.mod_chol(d_b.contiguous(), gmw=False)[0]
        l_b = torch.where(torch.isfinite(l_b).all(-1).all(-1)[..., None, None], l_b, nan_block)
        full[..., b, :, b, :] = l_b
        l_prev = l_b
    return full.reshape(batch + (nb * k, nb * k))[..., :ns, :ns]


def _factor_and_solve(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lower factor L of PD(ish) blocks a [..., ns, ns], solution of
    L L^T x = b).  Small blocks go to the modified Cholesky and its solve in
    one launch (`cuda_chol.factor_solve`); the GMW boosts engage only if
    roundoff made a block numerically indefinite (`correct_direction` then
    refines toward the true system)."""
    if a.shape[-1] <= _UNROLL_MAX:
        l, _, x = cuda_chol.factor_solve(a.contiguous(), b.contiguous())
        return l, x
    l = _factor_block_tridiag(a)
    return l, _factor_solve(l, b)


def _factor_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b given `_factor_and_solve`'s factor; b is [..., ns]
    or [..., ns, r].  Past ns = 64 the factor is block-bidiagonal: a forward
    and a backward substitution over its 18 x 18 blocks."""
    ns = l.shape[-1]
    if ns <= _UNROLL_MAX:
        return cuda_chol.chol_solve(l.contiguous(), b.contiguous())
    vec = b.ndim == l.ndim - 1
    rhs = b[..., None] if vec else b
    blocks, nb = _pad_blocks(l)
    k = _BT_BLOCK
    rows = [rhs[..., i * k:(i + 1) * k, :] for i in range(nb)]
    if nb * k > ns:
        rows[-1] = torch.cat([rows[-1], rhs.new_zeros(rhs.shape[:-2] + (nb * k - ns, rhs.shape[-1]))],
                             -2)
    y = []
    for i in range(nb):                                  # L y = b
        r = rows[i] if not i else rows[i] - blocks[..., i, :, i - 1, :] @ y[-1]
        y.append(torch.linalg.solve_triangular(blocks[..., i, :, i, :], r, upper=False))
    x = [None] * nb
    for i in reversed(range(nb)):                        # L^T x = y
        r = y[i] if i == nb - 1 else y[i] - blocks[..., i + 1, :, i, :].transpose(-1, -2) @ x[i + 1]
        x[i] = torch.linalg.solve_triangular(blocks[..., i, :, i, :].transpose(-1, -2), r, upper=True)
    out = torch.cat(x, -2)[..., :ns, :]
    return out[..., 0] if vec else out


class ReducedKKT(NamedTuple):
    """Per-robot reduced system (free spline coords + time scalar)."""

    a: torch.Tensor     # [ns, ns] spline block (SPD after per-piece repair)
    b: torch.Tensor     # [ns]     time coupling column
    gs: torch.Tensor    # [ns]     spline gradient
    gt: torch.Tensor    # []       time gradient
    htt: torch.Tensor   # []       time diagonal


def free_coord_indices(consts: SplineConsts) -> torch.Tensor:
    """[P, 18] flat free-DOF index per piece-local coordinate; pinned coords
    (two stored rows at each end) map to the dummy slot ``ns``."""
    t = consts.trajectory_num
    ns = 3 * (t - 4)
    rows = consts.piece_idx
    ok = (rows >= 2) & (rows <= t - 3)
    flat = 3 * (rows - 2)[..., None] + torch.arange(3, device=rows.device)
    flat = torch.where(ok[..., None], flat, ns)
    return flat.reshape(consts.piece_num, 3 * N_CP)


def assemble_reduced(consts: SplineConsts, g: torch.Tensor, h: torch.Tensor) -> ReducedKKT:
    """Scatter-add [..., P, 19] grads and [..., P, 19, 19] Hessians into the
    reduced system of each robot (leaves with the same leading axes)."""
    t = consts.trajectory_num
    ns = 3 * (t - 4)
    ix = free_coord_indices(consts)               # [P, 18]
    k = 3 * N_CP
    lead = g.shape[:-2]
    g_cp, g_t = g[..., :k].reshape(-1, ix.numel()), g[..., k]
    h_cp, h_ct, h_tt = h[..., :k, :k], h[..., :k, k].reshape(-1, ix.numel()), h[..., k, k]
    rows = g_cp.shape[0]

    flat2 = (ix[:, :, None] * (ns + 1) + ix[:, None, :]).reshape(-1)
    a = h.new_zeros((rows, (ns + 1) * (ns + 1))).index_add_(1, flat2, h_cp.reshape(rows, -1))
    a = a.reshape(lead + (ns + 1, ns + 1))[..., :ns, :ns]
    b = h.new_zeros((rows, ns + 1)).index_add_(1, ix.reshape(-1), h_ct)
    gs = g.new_zeros((rows, ns + 1)).index_add_(1, ix.reshape(-1), g_cp)
    return ReducedKKT(a=a, b=b.reshape(lead + (ns + 1,))[..., :ns],
                      gs=gs.reshape(lead + (ns + 1,))[..., :ns],
                      gt=g_t.sum(-1), htt=h_tt.sum(-1))


class LocalSolve(NamedTuple):
    """Robot-local solve results; enough to finish either time mode."""

    ainv_gs: torch.Tensor   # [ns]
    ainv_b: torch.Tensor    # [ns]
    schur_s: torch.Tensor   # [] h_tt - b^T A^-1 b
    schur_r: torch.Tensor   # [] gt  - b^T A^-1 gs
    gnorm: torch.Tensor     # [] norm of the full reduced gradient
    chol: torch.Tensor      # [ns, ns] lower Cholesky factor of A


def ridged_system(kkt: ReducedKKT) -> tuple[torch.Tensor, torch.Tensor]:
    """The matrix `local_solve` factors and its right-hand sides:
    (a + ridge I [..., ns, ns], [gs b] [..., ns, 2]).  The tiny relative
    ridge keeps the f32 factorization of the (PSD by construction) block
    safely positive definite."""
    ns = kkt.a.shape[-1]
    ridge = 1e-6 * torch.diagonal(kkt.a, dim1=-2, dim2=-1).sum(-1) / ns
    a = kkt.a + ridge[..., None, None] * torch.eye(ns, dtype=kkt.a.dtype, device=kkt.a.device)
    return a, torch.stack([kkt.gs, kkt.b], dim=-1)


def schur_terms(kkt: ReducedKKT, sol: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(A^-1 gs, A^-1 b, schur_s, schur_r, gnorm) from ``sol`` = [A^-1 gs,
    A^-1 b] [..., ns, 2]."""
    ainv_gs, ainv_b = sol[..., 0], sol[..., 1]
    schur_s = kkt.htt - torch.einsum("...i,...i->...", kkt.b, ainv_b)
    schur_r = kkt.gt - torch.einsum("...i,...i->...", kkt.b, ainv_gs)
    gnorm = torch.sqrt(torch.sum(kkt.gs ** 2, dim=-1) + kkt.gt ** 2)
    return ainv_gs, ainv_b, schur_s, schur_r, gnorm


def local_solve(kkt: ReducedKKT) -> LocalSolve:
    chol, sol = _factor_and_solve(*ridged_system(kkt))
    return LocalSolve(*schur_terms(kkt, sol), chol)


def finish_direction(
    ls: LocalSolve, schur_s_total: torch.Tensor, schur_r_total: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Newton direction from the Schur scalars.  The floor on ``s`` is
    relative: cancellation in ``htt - b^T A^-1 b`` can make the raw scalar
    tiny or negative."""
    s = torch.maximum(schur_s_total, 1e-5 * torch.clamp(schur_s_total.abs(), min=1.0))
    dt = torch.broadcast_to(-schur_r_total / s, ls.ainv_gs.shape[:-1])
    ds = -ls.ainv_gs - dt[..., None] * ls.ainv_b
    return ds, dt


def correct_direction(
    red: ReducedKKT, ls: LocalSolve, ds: torch.Tensor, dt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One iterative-refinement residual for the arrowhead system:
    (r_s, r_t, A^-1 r_s).  Recovers the digits f32 loses on ill-conditioned
    blocks."""
    r_s, r_t = refinement_residual(red, ds, dt)
    return r_s, r_t, _factor_solve(ls.chol, r_s)


def refinement_residual(
    red: ReducedKKT, ds: torch.Tensor, dt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The arrowhead system's residual at (ds, dt): (r_s, r_t)."""
    r_s = torch.einsum("...ij,...j->...i", red.a, ds) + red.b * dt[..., None] + red.gs
    r_t = torch.einsum("...i,...i->...", red.b, ds) + red.htt * dt + red.gt
    return r_s, r_t


def spread_direction(consts: SplineConsts, ds: torch.Tensor) -> torch.Tensor:
    """[..., ns] free-coordinate direction -> [..., T, 3] stored-row
    direction (pinned rows zero)."""
    t = consts.trajectory_num
    lead = ds.shape[:-1]
    d = ds.new_zeros(lead + (t, 3))
    d[..., 2 : t - 2, :] = ds.reshape(lead + (t - 4, 3))
    return d
