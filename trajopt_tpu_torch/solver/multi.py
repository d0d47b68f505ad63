"""Multi-robot consensus ADMM: decoupled and coupled-time modes.

Port of `trajopt_tpu/solver/multi.py` for one device.  The robot axis U is
a batch axis written out: the per-robot gradients, Hessians, KKT systems,
slack updates and CCD tables of the whole fleet go through each op (and
each kernel) in one call.  The reference's collectives (`_gsum`, `_gany`,
`_gmin` over ``axis_name``) are plain reductions here, and every
`lax.cond` / `while_loop` of its step is a Python branch, i.e. a host sync:
the live-pair gates of the obstacle and pair planes, the plateau and GJK
gates of both CCDs, the GJK gate of each decoupled shrink round and the
round's own loop test, and the coupled Armijo's step0 test.

Not ported: the plane caches (``optimal_plane=True``), grouped fleets
(``groups > 1``), independent-scenario batches (``interact=False``) and
robot sharding; each raises `NotImplementedError`.

State convention: a `SolverState` whose leaves carry a leading robot axis
U; ``piece_time`` is [U] in both modes (coupled keeps the entries equal).
"""

from __future__ import annotations

import torch
from torch.func import vmap

from ..config import TrajOptConfig
from ..ops import broadphase as bp
from ..ops import ccd as ccd_ops
from ..ops import cuda_topk
from ..ops import energies as en
from ..ops import geometry as geo
from ..ops import gradients as gr
from ..ops import kkt
from ..ops import splines as sp
from ..types import Planes, Scene, SolverState, SplineConsts, StepDiag, concat_planes, init_state
from . import admm

_SHRINK = admm._SHRINK
_ARMIJO_C = admm._ARMIJO_C


def init_multi_state(ops: sp.SplineOps, way_points_list, init_piece_time: float = 20.0,
                     *, device, dtype) -> SolverState:
    """Stacked per-robot initial states (multi layout)."""
    states = [init_state(ops, wp, init_piece_time, device=device, dtype=dtype, layout="multi")
              for wp in way_points_list]
    return SolverState(*(torch.stack(leaves) for leaves in zip(*states)))


# ---------------------------------------------------------------------------
# Inter-robot separating planes
# ---------------------------------------------------------------------------


def self_planes(consts: SplineConsts, cfg: TrajOptConfig, splines: torch.Tensor
                ) -> tuple[Planes, torch.Tensor]:
    """Per-robot plane tables against the ``max_self_planes`` nearest other
    robots' hulls at each segment (K1), fitted as offset mid-planes by one
    fleet-wide GJK batch (K2) compacted to the ``self_plane_gjk_budget``
    nearest in-radius pairs, then the 1-D barrier Newton on the offset.
    Returns (planes [U,P,R,Ks,...], overflow)."""
    u = splines.shape[0]
    hulls = en.seg_cps(consts, splines)                      # [U,P,R,n,3]
    _, p, r, n, _ = hulls.shape
    ks = min(cfg.max_self_planes, max(u - 1, 1))
    radius = cfg.offset + 2 * cfg.margin
    dtype, device = splines.dtype, splines.device

    lo, hi = bp.hull_aabbs(hulls)                            # [U,P,R,3]
    gap = torch.maximum(lo[:, None] - hi[None], torch.clamp(lo[None] - hi[:, None], min=0.0))
    d2 = torch.sum(gap * gap, dim=-1)                        # [U,Ut,P,R]
    eye = torch.eye(u, dtype=torch.bool, device=device)
    d2 = torch.where(eye[:, :, None, None], float("inf"), d2).permute(0, 2, 3, 1).contiguous()
    nf = u * p * r * ks
    budget = min(nf, cfg.self_plane_gjk_budget)
    shape = (u, p, r, ks)

    nd2, idx = cuda_topk.smallest_k(d2, ks)                  # [U,P,R,Ks]
    flat_mask = (nd2 <= radius * radius).reshape(-1)
    overflow = flat_mask.sum() > budget
    if not bool(flat_mask.any()):
        # no robot pair in radius: no GJK, no plane
        return Planes(c=torch.zeros(shape + (3,), dtype=dtype, device=device),
                      d=torch.zeros(shape, dtype=dtype, device=device),
                      mask=torch.zeros(shape, dtype=torch.bool, device=device)), overflow
    geo.check_gjk_route(cfg, device)
    p_idx = torch.arange(p, device=device)[None, :, None, None]
    r_idx = torch.arange(r, device=device)[None, None, :, None]
    other = hulls[idx, p_idx, r_idx]                         # [U,P,R,Ks,n,3]
    d2f = torch.where(flat_mask, nd2.reshape(-1), float("inf"))
    # the JAX step calls lax.top_k directly here (not the Pallas kernel)
    _, sel = cuda_topk.smallest_k_plain(d2f, budget)
    mine = hulls.reshape(-1, n, 3)[sel // ks]                # [B,n,3]
    other = other.reshape(-1, n, 3)[sel]
    hd = geo.batched_origin_dist(geo.minkowski_diff(mine, other), cfg.gjk_iters)
    c = hd.v / torch.clamp(hd.dist, min=1e-12)[:, None]
    d0 = (-torch.einsum("nmd,nd->nm", other, c)).amin(dim=1)
    d1 = (-torch.einsum("nmd,nd->nm", mine, c)).amax(dim=1)
    d = geo.optimal_d(mine, other, c, 0.5 * (d0 + d1), cfg.offset, cfg.margin, 8)
    # near-contact feasibility clamp on this robot's own side (see
    # admm._fit_obstacle_planes): keeps the plane live instead of infeasible
    my_smin = torch.einsum("nmd,nd->nm", mine, c).amin(dim=1)
    d_store = torch.maximum(d - 0.5 * cfg.offset, 1e-3 * cfg.margin - my_smin)
    valid = hd.dist <= cfg.offset + 2 * cfg.margin
    c_full = torch.zeros((nf, 3), dtype=dtype, device=device).index_copy(0, sel, c)
    d_full = torch.zeros((nf,), dtype=dtype, device=device).index_copy(0, sel, d_store)
    ok_full = torch.zeros((nf,), dtype=torch.bool, device=device).index_copy(
        0, sel, flat_mask[sel] & valid
    )
    return Planes(c=c_full.reshape(shape + (3,)), d=d_full.reshape(shape),
                  mask=ok_full.reshape(shape)), overflow


# ---------------------------------------------------------------------------
# CCD steps
# ---------------------------------------------------------------------------


def _obstacle_max_steps(cfg, hulls, dhulls, scene) -> torch.Tensor:
    """[U] analytic obstacle max-step per robot."""
    return ccd_ops.obstacle_max_step_direct(
        hulls, dhulls, scene.points, scene.mask, cfg.offset, cfg.gjk_iters,
        s1_slots=max(8, cfg.max_ccd_candidates), n_slots=cfg.ccd_gjk_slots,
        seg_budget=cfg.ccd_seg_budget,
    )


def coupled_ccd_step(consts: SplineConsts, cfg: TrajOptConfig, splines, directions,
                     scene: Scene) -> torch.Tensor:
    """One fleet-wide step (Step::couple_self_step + per-robot position_step):
    the obstacle and robot-pair analytic max-steps min-reduced over the
    fleet, floored to the 0.8^k rung lattice."""
    geo.check_gjk_route(cfg, splines.device)
    hulls = en.seg_cps(consts, splines)
    dhulls = en.seg_cps(consts, directions)
    gids = torch.arange(splines.shape[0], device=splines.device)
    s_obs = _obstacle_max_steps(cfg, hulls, dhulls, scene)
    s_pair = ccd_ops.pair_max_step_direct(
        hulls, dhulls, hulls, dhulls, gids, cfg.offset, cfg.gjk_iters,
        k_partners=max(1, 2 * cfg.max_self_planes), n_slots=cfg.ccd_pair_gjk_slots,
    )
    return admm.rung_floor(cfg, torch.minimum(s_obs, s_pair).amin())


def decoupled_ccd_steps(consts: SplineConsts, cfg: TrajOptConfig, splines, directions,
                        scene: Scene) -> torch.Tensor:
    """[U] per-robot steps: the pairwise shrink fixpoint (a robot whose
    pairs are not all certified shrinks by 0.8, at most ``max_line_search``
    rounds, then freezes at 0), min the per-robot rung-floored obstacle
    limit.  Each round is one host sync."""
    geo.check_gjk_route(cfg, splines.device)
    u = splines.shape[0]
    hulls = en.seg_cps(consts, splines)
    dhulls = en.seg_cps(consts, directions)
    gids = torch.arange(u, device=splines.device)
    tabs = ccd_ops.build_pair_ccd(hulls, dhulls, hulls, dhulls, gids,
                                  min(cfg.max_self_planes, max(u - 1, 1)))
    steps = torch.ones((u,), dtype=splines.dtype, device=splines.device)
    bad = ccd_ops.pair_bad(tabs, steps, steps, cfg.offset, cfg.gjk_iters)
    rounds = 0
    while rounds < cfg.max_line_search and bool(bad.any()):
        steps = torch.where(bad, steps * _SHRINK, steps)
        bad = ccd_ops.pair_bad(tabs, steps, steps, cfg.offset, cfg.gjk_iters)
        rounds += 1
    # robots still uncertified freeze at 0 (shrinking a robot's interval
    # only shrinks swept hulls, so this never invalidates another's)
    steps = torch.where(bad, torch.zeros_like(steps), steps)
    obs_steps = admm.rung_floor(cfg, _obstacle_max_steps(cfg, hulls, dhulls, scene))
    return torch.minimum(steps, obs_steps)


# ---------------------------------------------------------------------------
# Full iteration
# ---------------------------------------------------------------------------


def _all_planes(consts, cfg, state, scene) -> tuple[Planes, torch.Tensor]:
    """Fleet plane tables (obstacle slots, then robot-pair slots) and the
    overflow flag."""
    if cfg.optimal_plane:
        raise NotImplementedError(
            "optimal_plane=True (the multi-robot plane caches) is not ported to torch yet"
        )
    obstacle, overflow = admm.separate_planes_batch(consts, cfg, state.spline, scene)
    if state.spline.shape[0] > 1:
        slf, self_overflow = self_planes(consts, cfg, state.spline)
        return concat_planes(obstacle, slf), overflow | self_overflow
    return obstacle, overflow


def _directions(consts, cfg, state, planes):
    """Per-robot reduced KKT solves on the stacked [U, ...] blocks: one PSD
    repair (K3) over all U*P pieces, one fused factor and solve (K3 + K4 in
    one launch) over the U systems."""
    g, h = gr.piece_grads_and_hessians(
        consts, cfg, state.spline, state.piece_time, planes,
        state.p_slack, state.t_slack, state.p_lambda, state.t_lambda, repair=False,
    )
    red = kkt.assemble_reduced(consts, g, gr.apply_psd_repair(cfg, h))
    return kkt.local_solve(red), red


def _coupled_update(consts, cfg, state, planes, ls, red, scene):
    """Shared-time spline update (Optimization3D_multi.h:120-174): the Schur
    scalars and the Armijo energies are summed over the fleet."""
    u = state.spline.shape[0]
    s_tot = ls.schur_s.sum()
    ds, dt = kkt.finish_direction(ls, s_tot, ls.schur_r.sum())   # dt [U]
    # one iterative-refinement round (f32 Schur cancellation guard)
    _, rt_local, ainv_rs = kkt.correct_direction(red, ls, ds, dt)
    br = torch.einsum("ui,ui->u", red.b, ainv_rs).sum()
    s_safe = torch.maximum(s_tot, 1e-5 * torch.clamp(s_tot.abs(), min=1.0))
    cdt = -(rt_local.sum() - br) / s_safe
    ds = ds + (-ainv_rs - cdt * ls.ainv_b)
    dt = dt + cdt
    gt_tot = red.gt.sum()
    wolfe = -(torch.einsum("ui,ui->u", ds, red.gs).sum() + dt[0] * gt_tot)
    # steepest-descent fallback, NaN-proof
    finite = torch.isfinite(wolfe) & torch.all(torch.isfinite(ds)) & torch.all(torch.isfinite(dt))
    bad = ~finite | ~(wolfe > 0)
    gs2 = torch.sum(red.gs ** 2, dim=1).sum()
    ds = torch.where(bad, -red.gs, ds)
    dt = torch.where(bad, -gt_tot, dt)
    wolfe = torch.where(bad, gs2 + gt_tot ** 2, wolfe)
    directions = kkt.spread_direction(consts, ds)
    gnorm = torch.sqrt(gs2 + gt_tot ** 2) / u

    step0 = coupled_ccd_step(consts, cfg, state.spline, directions, scene)
    t0 = state.piece_time[0]
    step0 = torch.where(t0 + step0 * dt[0] <= 0, -0.95 * t0 / dt[0], step0)
    ttab = en.build_trial_tables(consts, cfg, state, planes, directions, dt)

    def fleet_energy(step):
        return en.trial_energy(consts, cfg, ttab, step).sum()

    e0 = fleet_energy(torch.zeros((), dtype=t0.dtype, device=t0.device))
    e_step0 = fleet_energy(step0)
    if bool(e0 - _ARMIJO_C * wolfe * step0 >= e_step0):
        step, e_acc = step0, e_step0
    else:
        ladder = admm.step_candidates(cfg, t0.dtype, t0.device) * step0   # [S]

        def accepted(step):
            return e0 - _ARMIJO_C * wolfe * step >= fleet_energy(step)

        ok = admm.staged_ladder_ok(vmap(accepted), ladder)
        step = ladder[admm._first_true(admm._with_floor_fallback(ok))]
        e_acc = fleet_energy(step)
    spline = state.spline + step * directions
    piece_time = state.piece_time + step * dt[0]
    return spline, piece_time, step.expand(u), step0.expand(u), gnorm, e_acc


def _decoupled_update(consts, cfg, state, planes, ls, red, scene):
    """Per-robot-time spline update (Optimization3D_multi.h:29-118): each
    robot's own Newton direction, CCD step and Armijo rung."""
    u = state.spline.shape[0]
    ds, dt = kkt.finish_direction(ls, ls.schur_s, ls.schur_r)
    _, rt, ainv_rs = kkt.correct_direction(red, ls, ds, dt)
    br = torch.einsum("ui,ui->u", red.b, ainv_rs)
    s_safe = torch.maximum(ls.schur_s, 1e-5 * torch.clamp(ls.schur_s.abs(), min=1.0))
    cdt = -(rt - br) / s_safe
    ds = ds + (-ainv_rs - cdt[:, None] * ls.ainv_b)
    dt = dt + cdt
    wolfe = -(torch.einsum("ui,ui->u", ds, red.gs) + dt * red.gt)   # [U]
    finite = torch.isfinite(wolfe) & torch.all(torch.isfinite(ds), dim=1) & torch.isfinite(dt)
    bad = ~finite | ~(wolfe > 0)
    ds = torch.where(bad[:, None], -red.gs, ds)
    dt = torch.where(bad, -red.gt, dt)
    wolfe = torch.where(bad, torch.sum(red.gs ** 2, dim=1) + red.gt ** 2, wolfe)
    directions = kkt.spread_direction(consts, ds)
    gnorm = ls.gnorm.sum() / u

    ccd_steps = decoupled_ccd_steps(consts, cfg, state.spline, directions, scene)
    step0 = torch.where(state.piece_time + ccd_steps * dt <= 0,
                        -0.95 * state.piece_time / dt, ccd_steps)
    ttab = en.build_trial_tables(consts, cfg, state, planes, directions, dt)

    def robot_energy(step_vec):
        return en.trial_energy(consts, cfg, ttab, step_vec)

    e0 = robot_energy(torch.zeros((u,), dtype=dt.dtype, device=dt.device))
    # parallel Armijo ladder per robot: [S, U]
    ladder = admm.step_candidates(cfg, dt.dtype, dt.device)[:, None] * step0[None, :]
    ok = admm.staged_ladder_ok(
        vmap(lambda sv: e0 - _ARMIJO_C * wolfe * sv >= robot_energy(sv)), ladder
    )
    ok = admm._with_floor_fallback(ok)
    steps = torch.gather(ladder, 0, admm._first_true(ok, dim=0)[None, :])[0]
    spline = state.spline + steps[:, None, None] * directions
    piece_time = state.piece_time + steps * dt
    # diagnostic energy at the accepted steps, before the slack update
    e_acc = robot_energy(steps).sum()
    return spline, piece_time, steps, ccd_steps, gnorm, e_acc


def multi_admm_step(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,          # leaves have a leading robot axis U
    scene: Scene,
    coupled: bool,
    interact: bool = True,
    groups: int = 1,
) -> tuple[SolverState, StepDiag]:
    """One multi-robot ADMM iteration (coupled: Optimization3D_multi.h:120-174;
    decoupled: :29-118)."""
    if not interact:
        raise NotImplementedError("interact=False (scenario batches) is not ported to torch yet")
    if groups != 1:
        raise NotImplementedError("groups > 1 (grouped coupled fleets) is not ported to torch yet")
    # Full-f32 matmuls are required: the KKT blocks reach condition ~1e6 and
    # reduced-precision passes give NaN Cholesky pivots.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    planes, plane_overflow = _all_planes(consts, cfg, state, scene)
    ls, red = _directions(consts, cfg, state, planes)
    update = _coupled_update if coupled else _decoupled_update
    spline, piece_time, steps, ccd_steps, gnorm, e_acc = update(
        consts, cfg, state, planes, ls, red, scene
    )
    state, residual = admm.slack_update(
        consts, cfg, state._replace(spline=spline, piece_time=piece_time)
    )
    diag = StepDiag(
        gnorm=gnorm,
        consensus_residual=torch.sqrt(torch.sum(residual ** 2)),
        step=steps.amin(),
        ccd_step=ccd_steps.amin(),
        n_planes=planes.mask.sum(),
        energy=e_acc,
        infeasible=~torch.isfinite(e_acc),
        plane_overflow=plane_overflow,
    )
    return state, diag
