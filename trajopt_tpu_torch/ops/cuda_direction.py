"""The direction phase's glue in four CUDA launches around K3, K3+K4 and K4.

`solver.admm.spline_direction` on the card, for one UAV under
``psd_method="gmw"`` and ``grad_mode="analytic"`` with a reduced system of
at most 64 coordinates (P <= 7), is seven launches (``csrc/direction.cu``):

1. `dir_grad_hess`: each piece's gradient g [P,19] and Hessian h [P,19,19]
   (`gradients.gather_piece_data` and `gradients.analytic_spline_gh`);
2. `cuda_chol.mod_chol` (K3, ``want_l=False``): the GMW shift e;
3. `dir_assemble`: h + diag(e) scattered into the reduced system
   (`kkt.assemble_reduced`) and `kkt.local_solve`'s ridged matrix and
   right-hand sides;
4. `cuda_chol.factor_solve` (K3+K4) on them;
5. `dir_schur`: the Schur scalars, gnorm, `kkt.finish_direction` and the
   refinement residual of `kkt.correct_direction`;
6. `cuda_chol.chol_solve` (K4) on that residual;
7. `dir_finish`: the Schur correction, the steepest-descent fallback and
   `kkt.spread_direction`.

These kernels replace no TPU kernel: they fuse what the JAX package leaves
to XLA around its Pallas K3 and K4.  Each wrapper takes its plain version
(``*_plain``, the slice of `solver.admm.spline_direction_plain` it
replaces) for CPU tensors and launches its kernel for float32 CUDA tensors
in the layouts it checks, or raises.  Composed, the plain versions and the K3/K4
wrappers' plain versions are `spline_direction_plain` bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TrajOptConfig
from ..types import Planes, SolverState, SplineConsts
from . import _cuda, kkt
from . import gradients as gr

KERNELS = ("dir_grad_hess", "dir_assemble", "dir_schur", "dir_finish")


class Assembled(NamedTuple):
    """`dir_assemble`'s outputs."""

    red: kkt.ReducedKKT   # the reduced system, a without the ridge
    a: torch.Tensor       # [ns, ns] `kkt.local_solve`'s ridged matrix
    rhs: torch.Tensor     # [ns, 2]  its right-hand sides [gs b]


class Schur(NamedTuple):
    """`dir_schur`'s outputs."""

    ainv_b: torch.Tensor    # [ns] A^-1 b
    schur_s: torch.Tensor   # []   h_tt - b^T A^-1 b
    gnorm: torch.Tensor     # []   norm of the reduced gradient
    ds: torch.Tensor        # [ns] the Newton step (`kkt.finish_direction`)
    dt: torch.Tensor        # []
    r_s: torch.Tensor       # [ns] the refinement residual
    r_t: torch.Tensor       # []


class Finished(NamedTuple):
    """`dir_finish`'s outputs: `solver.admm.SplineDirection`'s four fields
    and whether the steepest-descent fallback was taken."""

    direction: torch.Tensor    # [T, 3]
    t_direction: torch.Tensor  # []
    wolfe: torch.Tensor        # []
    gnorm: torch.Tensor        # []
    bad: torch.Tensor          # [] bool (plain) or int32 (kernel)


def engages(consts: SplineConsts, cfg: TrajOptConfig, spline) -> bool:
    """Whether `solver.admm.spline_direction` takes the kernels: a single
    UAV's float32 spline on the card, the GMW repair (K3), the closed-form
    Hessian, and a reduced system that `kkt` factors densely (ns = 9P - 3
    <= 64).  Reads only ``spline``'s device, dtype and ndim."""
    return (spline.device.type == "cuda" and spline.dtype == torch.float32 and spline.ndim == 2
            and cfg.psd_method == "gmw" and cfg.grad_mode == "analytic"
            and 3 * (consts.trajectory_num - 4) <= kkt._UNROLL_MAX)


# ---------------------------------------------------------------------------
# plain versions: the slices of spline_direction_plain
# ---------------------------------------------------------------------------


def dir_grad_hess_plain(consts: SplineConsts, cfg: TrajOptConfig, state: SolverState,
                        planes: Planes) -> tuple[torch.Tensor, torch.Tensor]:
    return gr.piece_grads_and_hessians(
        consts, cfg, state.spline, state.piece_time, planes,
        state.p_slack, state.t_slack, state.p_lambda, state.t_lambda, repair=False,
    )


def dir_assemble_plain(consts: SplineConsts, g: torch.Tensor, h: torch.Tensor,
                       e: torch.Tensor) -> Assembled:
    m = h.shape[-1]
    h = h + e[..., None] * torch.eye(m, dtype=h.dtype, device=h.device)   # psd_repair_gmw
    red = kkt.assemble_reduced(consts, g, h)
    return Assembled(red, *kkt.ridged_system(red))


def dir_schur_plain(red: kkt.ReducedKKT, x: torch.Tensor) -> Schur:
    ainv_gs, ainv_b, schur_s, schur_r, gnorm = kkt.schur_terms(red, x)
    ls = kkt.LocalSolve(ainv_gs, ainv_b, schur_s, schur_r, gnorm, None)
    ds, dt = kkt.finish_direction(ls, schur_s, schur_r)
    return Schur(ainv_b, schur_s, gnorm, ds, dt, *kkt.refinement_residual(red, ds, dt))


def dir_finish_plain(consts: SplineConsts, red: kkt.ReducedKKT, sch: Schur,
                     ainv_rs: torch.Tensor) -> Finished:
    s_safe = torch.maximum(sch.schur_s, 1e-5 * torch.clamp(sch.schur_s.abs(), min=1.0))
    cdt = -(sch.r_t - red.b @ ainv_rs) / s_safe
    ds = sch.ds + (-ainv_rs - cdt * sch.ainv_b)
    dt = sch.dt + cdt
    wolfe = -(ds @ red.gs + dt * red.gt)
    finite = torch.isfinite(wolfe) & torch.all(torch.isfinite(ds)) & torch.isfinite(dt)
    bad = ~finite | ~(wolfe > 0)
    ds = torch.where(bad, -red.gs, ds)
    dt = torch.where(bad, -red.gt, dt)
    wolfe = torch.where(bad, torch.sum(red.gs ** 2) + red.gt ** 2, wolfe)
    return Finished(kkt.spread_direction(consts, ds), dt, wolfe, sch.gnorm, bad)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU inputs (the plain version runs); True for float32 CUDA
    ones; raises for any other.  Each wrapper checks the layouts its kernel
    reads (some vectors are strided columns of [ns, 2] buffers)."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA (or CPU) tensor, got {t.device}")
    return True


def _check_index(name: str, idx: torch.Tensor, device: torch.device) -> None:
    if idx.dtype != torch.int64 or idx.device != device or not idx.is_contiguous():
        raise ValueError(f"{name}: piece_idx must be a contiguous int64 tensor on the state's "
                         f"device")


def dir_grad_hess(consts: SplineConsts, cfg: TrajOptConfig, state: SolverState,
                  planes: Planes) -> tuple[torch.Tensor, torch.Tensor]:
    """The closed-form gradient [P,19] and unrepaired Hessian [P,19,19] of
    each piece of one UAV's spline subproblem (one block a piece)."""
    floats = (state.spline, state.piece_time, state.p_slack, state.t_slack, state.p_lambda,
              state.t_lambda, consts.seg_basis, consts.seg_weight, consts.convert, planes.c,
              planes.d)
    floats = tuple(t.contiguous() for t in floats)
    if not _on_card("dir_grad_hess", *floats):
        return dir_grad_hess_plain(consts, cfg, state, planes)
    spline, piece_time, p_slack, t_slack, p_lambda, t_lambda, basis, weight, convert, c, d = floats
    pieces, res = consts.piece_num, consts.res
    k = planes.mask.shape[-1]
    if (spline.ndim != 2 or piece_time.ndim != 0 or p_slack.shape != (pieces, gr.N_CP, 3)
            or t_slack.shape != (pieces,) or p_lambda.shape != p_slack.shape
            or t_lambda.shape != t_slack.shape or c.shape != (pieces, res, k, 3)
            or d.shape != (pieces, res, k) or planes.mask.shape != d.shape
            or basis.shape != (pieces, res, gr.N_CP, gr.N_CP)):
        raise ValueError(f"dir_grad_hess: one UAV's state of {pieces} pieces and a "
                         f"[{pieces},{res},K] plane table, got {tuple(p_slack.shape)} and "
                         f"{tuple(planes.mask.shape)}")
    if planes.mask.dtype != torch.bool:
        raise TypeError("dir_grad_hess: the plane mask must be bool")
    mask = planes.mask.contiguous()
    _check_index("dir_grad_hess", consts.piece_idx, spline.device)
    g = spline.new_empty((pieces, gr.N_LOC))
    h = spline.new_empty((pieces, gr.N_LOC, gr.N_LOC))
    err = _cuda.lib().trajopt_dir_grad_hess(
        spline.data_ptr(), consts.piece_idx.data_ptr(), basis.data_ptr(), weight.data_ptr(),
        convert.data_ptr(), c.data_ptr(), d.data_ptr(), mask.data_ptr(), piece_time.data_ptr(),
        p_slack.data_ptr(), t_slack.data_ptr(), p_lambda.data_ptr(), t_lambda.data_ptr(),
        g.data_ptr(), h.data_ptr(), pieces, res, k, cfg.lam, cfg.mu, cfg.margin, cfg.vel_limit,
        cfg.acc_limit, _cuda.stream(),
    )
    _cuda.check_launch(err, "dir_grad_hess", (planes.mask.shape, "pieces", pieces))
    return g, h


def dir_assemble(consts: SplineConsts, g: torch.Tensor, h: torch.Tensor,
                 e: torch.Tensor) -> Assembled:
    """h + diag(e) scattered into one UAV's reduced system, the ridged
    matrix and the right-hand sides [gs b] (one block)."""
    if not _on_card("dir_assemble", g, h, e):
        return dir_assemble_plain(consts, g, h, e)
    pieces, ns = consts.piece_num, 3 * (consts.trajectory_num - 4)
    if (g.shape != (pieces, gr.N_LOC) or h.shape != (pieces, gr.N_LOC, gr.N_LOC)
            or e.shape != g.shape or not 0 < ns <= kkt._UNROLL_MAX):
        raise ValueError(f"dir_assemble: {pieces} pieces (ns = {ns} <= {kkt._UNROLL_MAX}), got "
                         f"g {tuple(g.shape)}, h {tuple(h.shape)}, e {tuple(e.shape)}")
    _check_index("dir_assemble", consts.piece_idx, g.device)
    a, a_ridged = g.new_empty((ns, ns)), g.new_empty((ns, ns))
    rhs, scal = g.new_empty((ns, 2)), g.new_empty(2)
    err = _cuda.lib().trajopt_dir_assemble(
        g.data_ptr(), h.data_ptr(), e.data_ptr(), consts.piece_idx.data_ptr(), a.data_ptr(),
        a_ridged.data_ptr(), rhs.data_ptr(), scal.data_ptr(), pieces, ns, _cuda.stream(),
    )
    _cuda.check_launch(err, "dir_assemble", (h.shape, "ns", ns))
    red = kkt.ReducedKKT(a=a, b=rhs[:, 1], gs=rhs[:, 0], gt=scal[0], htt=scal[1])
    return Assembled(red, a_ridged, rhs)


def _check_vectors(name: str, ns: int, *vectors: torch.Tensor) -> None:
    if any(v.shape != (ns,) for v in vectors) or vectors[0].stride() != vectors[1].stride():
        raise ValueError(f"{name}: [ns] vectors of one stride, got "
                         f"{[tuple(v.shape) for v in vectors]}")


def dir_schur(red: kkt.ReducedKKT, x: torch.Tensor) -> Schur:
    """The Schur scalars, gnorm, the Newton step and the refinement residual
    from x = [A^-1 gs, A^-1 b] (one block)."""
    if not _on_card("dir_schur", red.a, red.b, red.gs, red.gt, red.htt, x):
        return dir_schur_plain(red, x)
    ns = red.a.shape[-1]
    _check_vectors("dir_schur", ns, red.gs, red.b)
    if (red.a.shape != (ns, ns) or red.a.stride(1) != 1 or x.shape != (ns, 2)
            or not x.is_contiguous() or red.gt.ndim or red.htt.ndim or ns > kkt._UNROLL_MAX):
        raise ValueError(f"dir_schur: a [ns,ns] with unit column stride and x [ns,2] contiguous "
                         f"with ns <= {kkt._UNROLL_MAX}, got {tuple(red.a.shape)} and "
                         f"{tuple(x.shape)}")
    ds, r_s, scal = x.new_empty(ns), x.new_empty(ns), x.new_empty(4)
    err = _cuda.lib().trajopt_dir_schur(
        red.a.data_ptr(), red.a.stride(0), red.gs.data_ptr(), red.b.data_ptr(), red.gs.stride(0),
        red.gt.data_ptr(), red.htt.data_ptr(), x.data_ptr(), ds.data_ptr(), r_s.data_ptr(),
        scal.data_ptr(), ns, _cuda.stream(),
    )
    _cuda.check_launch(err, "dir_schur", (red.a.shape, "ns", ns))
    return Schur(ainv_b=x[:, 1], schur_s=scal[0], gnorm=scal[3], ds=ds, dt=scal[1], r_s=r_s,
                 r_t=scal[2])


def dir_finish(consts: SplineConsts, red: kkt.ReducedKKT, sch: Schur,
               ainv_rs: torch.Tensor) -> Finished:
    """The refinement's Schur correction, wolfe, the steepest-descent
    fallback and the [T,3] direction (one block); ``bad`` an int32 flag."""
    tensors = (red.gs, red.b, red.gt, sch.ainv_b, sch.schur_s, sch.dt, sch.r_t, sch.gnorm, sch.ds,
               ainv_rs)
    if not _on_card("dir_finish", *tensors):
        return dir_finish_plain(consts, red, sch, ainv_rs)
    ns, rows = red.gs.shape[-1], consts.trajectory_num
    _check_vectors("dir_finish", ns, red.gs, red.b)
    if (sch.ainv_b.shape != (ns,) or sch.ds.shape != (ns,) or ainv_rs.shape != (ns,)
            or not (sch.ds.is_contiguous() and ainv_rs.is_contiguous())
            or any(t.ndim for t in (red.gt, sch.schur_s, sch.dt, sch.r_t, sch.gnorm))
            or ns != 3 * (rows - 4) or ns > kkt._UNROLL_MAX):
        raise ValueError(f"dir_finish: a reduced system of ns = 3 (T - 4) <= {kkt._UNROLL_MAX} "
                         f"with T = {rows}, got ns = {ns}")
    direction = red.gs.new_empty((rows, 3))
    out = red.gs.new_empty(3)
    bad = torch.empty((), dtype=torch.int32, device=red.gs.device)
    err = _cuda.lib().trajopt_dir_finish(
        red.gs.data_ptr(), red.b.data_ptr(), red.gs.stride(0), red.gt.data_ptr(),
        sch.ainv_b.data_ptr(), sch.ainv_b.stride(0), sch.schur_s.data_ptr(), sch.dt.data_ptr(),
        sch.r_t.data_ptr(), sch.gnorm.data_ptr(), sch.ds.data_ptr(), ainv_rs.data_ptr(),
        direction.data_ptr(), out.data_ptr(), bad.data_ptr(), ns, rows, _cuda.stream(),
    )
    _cuda.check_launch(err, "dir_finish", (red.a.shape, "ns", ns))
    return Finished(direction, out[0], out[1], out[2], bad)
