"""Multi-robot consensus ADMM: decoupled and coupled-time modes.

Port of `trajopt_tpu/solver/multi.py` for one device.  The robot axis U is
a batch axis written out: the per-robot gradients, Hessians, KKT systems,
slack updates and CCD tables of the whole fleet go through each op (and
each kernel) in one call.  The reference's collectives (`_gsum`, `_gany`,
`_gmin` over ``axis_name``) are plain reductions here.  Every `lax.cond` of
its step is a `runtime.graph.device_cond` (a Python branch, i.e. a host
sync, in the host-stepped drivers; both sides and a select in the fused
drivers' CUDA graph): the live-pair gates of the obstacle and pair planes,
the plateau and GJK gates of both CCDs, the GJK gate of each decoupled
shrink round, and the coupled Armijo's step0 test.  The decoupled shrink
`while_loop` is `graph.fixed_rounds`, at most ``max_line_search`` guarded
rounds.

``optimal_plane=True`` refines every obstacle and robot-pair plane, and
`multi_admm_step_cached` threads the persistent plane caches of both.  Not
ported: grouped fleets (``groups > 1``), independent-scenario batches
(``interact=False``) and robot sharding; each raises `NotImplementedError`.

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
from ..runtime import graph
from ..types import (PairPlaneCache, PlaneCache, Planes, Scene, SolverState, SplineConsts,
                     StepDiag, concat_planes, empty_pair_plane_cache, empty_plane_cache,
                     init_state)
from . import admm

_SHRINK = admm._SHRINK
_ARMIJO_C = admm._ARMIJO_C


def init_multi_state(ops: sp.SplineOps, way_points_list, init_piece_time: float = 20.0,
                     *, device, dtype) -> SolverState:
    """Stacked per-robot initial states (multi layout)."""
    states = [init_state(ops, wp, init_piece_time, device=device, dtype=dtype, layout="multi")
              for wp in way_points_list]
    return SolverState(*(torch.stack(leaves) for leaves in zip(*states)))


def init_multi_caches(cfg: TrajOptConfig, consts: SplineConsts, u: int, *, device, dtype
                      ) -> tuple[PlaneCache, PairPlaneCache]:
    """Empty persistent plane caches of a U-robot fleet (``optimal_plane=True``):
    the obstacle cache [U,P,R,K] and the pair cache [U,P,R,Ks]."""
    kw = dict(device=device, dtype=dtype)
    obs = empty_plane_cache(consts.piece_num, consts.res, cfg.max_planes, **kw)
    obs = PlaneCache(*(x.expand((u,) + x.shape).clone() for x in obs))
    ks = min(cfg.max_self_planes, max(u - 1, 1))
    return obs, empty_pair_plane_cache(u, consts.piece_num, consts.res, ks, **kw)


# ---------------------------------------------------------------------------
# Inter-robot separating planes
# ---------------------------------------------------------------------------


def self_planes(consts: SplineConsts, cfg: TrajOptConfig, splines: torch.Tensor,
                cache: PairPlaneCache | None = None):
    """Per-robot plane tables against the ``max_self_planes`` nearest other
    robots' hulls at each segment (K1), fitted as offset mid-planes by one
    fleet-wide GJK batch (K2) compacted to the ``self_plane_gjk_budget``
    nearest in-radius pairs, then the 1-D barrier Newton on the offset.

    ``cache``: a pair whose partner has a cached midplane that both current
    hulls still clear by offset/2 starts from it (Optimization3D_multi.h:
    278-327); ``cfg.optimal_plane`` then refines every fitted midplane
    (`geometry.refine_pair_plane`, kept where finite).  Returns (planes
    [U,P,R,Ks,...], overflow), and with a cache the new one: the refined
    midplane of each live slot keyed by its partner."""
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
    geo.check_gjk_route(cfg, device)

    def live():
        p_idx = torch.arange(p, device=device)[None, :, None, None]
        r_idx = torch.arange(r, device=device)[None, None, :, None]
        other = hulls[idx, p_idx, r_idx]                     # [U,P,R,Ks,n,3]
        d2f = torch.where(flat_mask, nd2.reshape(-1), float("inf"))
        # the JAX step calls lax.top_k directly here (not the Pallas kernel)
        _, sel = cuda_topk.smallest_k_plain(d2f, budget)
        mine = hulls.reshape(-1, n, 3)[sel // ks]            # [B,n,3]
        other = other.reshape(-1, n, 3)[sel]
        hd = geo.batched_origin_dist(geo.minkowski_diff(mine, other), cfg.gjk_iters)
        c = hd.v / torch.clamp(hd.dist, min=1e-12)[:, None]
        d0 = (-torch.einsum("nmd,nd->nm", other, c)).amin(dim=1)
        d1 = (-torch.einsum("nmd,nd->nm", mine, c)).amax(dim=1)
        d = geo.optimal_d(mine, other, c, 0.5 * (d0 + d1), cfg.offset, cfg.margin, 8)
        if cache is not None:
            match = idx[..., :, None] == cache.partner[..., None, :]     # [U,P,R,Ks,Ks]
            slot = torch.argmax(match.to(torch.uint8), dim=-1)           # first match
            hit = match.any(-1).reshape(-1)[sel]
            warm_c = torch.gather(cache.c, 3, slot[..., None].expand(shape + (3,))).reshape(-1, 3)[sel]
            warm_d = torch.gather(cache.d, 3, slot).reshape(-1)[sel]
            wa = torch.einsum("nmd,nd->nm", mine, warm_c) + warm_d[:, None]
            wb = -(torch.einsum("nmd,nd->nm", other, warm_c) + warm_d[:, None])
            warm_ok = hit & (wa > 0.5 * cfg.offset).all(1) & (wb > 0.5 * cfg.offset).all(1)
            c = torch.where(warm_ok[:, None], warm_c, c)
            d = torch.where(warm_ok, warm_d, d)
        if cfg.optimal_plane:
            c_r, d_r = geo.refine_pair_plane(mine, other, c, d, cfg.offset, cfg.margin)
            good = torch.isfinite(c_r).all(-1) & torch.isfinite(d_r)
            c = torch.where(good[:, None], c_r, c)
            d = torch.where(good, d_r, d)
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
        planes = Planes(c=c_full.reshape(shape + (3,)), d=d_full.reshape(shape),
                        mask=ok_full.reshape(shape))
        if cache is None:
            return planes
        # the new cache keys each slot's midplane offset
        d_mid = torch.zeros((nf,), dtype=dtype, device=device).index_copy(0, sel, d)
        return planes, d_mid.reshape(shape)

    def dead():
        # no robot pair in radius: no GJK, no plane
        planes = Planes(c=torch.zeros(shape + (3,), dtype=dtype, device=device),
                        d=torch.zeros(shape, dtype=dtype, device=device),
                        mask=torch.zeros(shape, dtype=torch.bool, device=device))
        return planes if cache is None else (planes, planes.d)

    out = graph.device_cond(flat_mask.any(), live, dead)
    if cache is None:
        return out, overflow
    planes, d_mid = out
    return planes, overflow, PairPlaneCache(
        partner=torch.where(planes.mask, idx, -1), c=planes.c, d=d_mid)


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
    limit.  The rounds are `graph.fixed_rounds` (the reference's
    `while_loop`)."""
    geo.check_gjk_route(cfg, splines.device)
    u = splines.shape[0]
    hulls = en.seg_cps(consts, splines)
    dhulls = en.seg_cps(consts, directions)
    gids = torch.arange(u, device=splines.device)
    tabs = ccd_ops.build_pair_ccd(hulls, dhulls, hulls, dhulls, gids,
                                  min(cfg.max_self_planes, max(u - 1, 1)))
    steps = torch.ones((u,), dtype=splines.dtype, device=splines.device)
    bad = ccd_ops.pair_bad(tabs, steps, steps, cfg.offset, cfg.gjk_iters)

    def shrink(steps, bad):
        steps = torch.where(bad, steps * _SHRINK, steps)
        return steps, ccd_ops.pair_bad(tabs, steps, steps, cfg.offset, cfg.gjk_iters)

    steps, bad = graph.fixed_rounds(cfg.max_line_search, lambda s, b: b.any(), shrink, steps, bad)
    # robots still uncertified freeze at 0 (shrinking a robot's interval
    # only shrinks swept hulls, so this never invalidates another's)
    steps = torch.where(bad, torch.zeros_like(steps), steps)
    obs_steps = admm.rung_floor(cfg, _obstacle_max_steps(cfg, hulls, dhulls, scene))
    return torch.minimum(steps, obs_steps)


# ---------------------------------------------------------------------------
# Full iteration
# ---------------------------------------------------------------------------


def _all_planes(consts, cfg, state, scene, caches=None):
    """Fleet plane tables (obstacle slots, then robot-pair slots) and the
    overflow flag, and with ``caches`` (obstacle `PlaneCache` [U,...],
    `PairPlaneCache`) the new caches.  The default obstacle tables compact
    the whole fleet's candidates into one budget (`separate_planes_batch`);
    with ``optimal_plane`` or caches each robot keeps its full table (the
    cache slots align with it), all robots in one GJK batch."""
    multi = state.spline.shape[0] > 1
    if caches is not None:
        obs_cache, pair_cache = caches
        obstacle, overflow, obs_cache = admm.separate_planes(
            consts, cfg, state.spline, scene, obs_cache)
        if multi:
            slf, self_overflow, pair_cache = self_planes(consts, cfg, state.spline, pair_cache)
            return (concat_planes(obstacle, slf), overflow | self_overflow,
                    (obs_cache, pair_cache))
        return obstacle, overflow, (obs_cache, pair_cache)
    if cfg.optimal_plane:
        obstacle, overflow = admm.separate_planes(consts, cfg, state.spline, scene)
    else:
        obstacle, overflow = admm.separate_planes_batch(consts, cfg, state.spline, scene)
    if multi:
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

    def accepted(step):
        return e0 - _ARMIJO_C * wolfe * step >= fleet_energy(step)

    def armijo_ladder():
        ladder = admm.step_candidates(cfg, t0.dtype, t0.device) * step0   # [S]
        ok = admm.staged_ladder_ok(vmap(accepted), ladder)
        step = ladder.gather(0, admm._first_true(admm._with_floor_fallback(ok))[None])[0]
        return step, fleet_energy(step)

    step, e_acc = graph.device_cond(e0 - _ARMIJO_C * wolfe * step0 >= e_step0,
                                    lambda: (step0, e_step0), armijo_ladder)
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
    with admm.full_f32_matmul():
        return _multi_step(consts, cfg, state, scene, coupled)


def multi_admm_step_cached(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,
    scene: Scene,
    coupled: bool,
    caches: tuple[PlaneCache, PairPlaneCache],
) -> tuple[SolverState, StepDiag, tuple[PlaneCache, PairPlaneCache]]:
    """`multi_admm_step` threading the persistent obstacle and pair plane
    caches (``optimal_plane=True`` semantics, Optimization3D_multi.h:278-327).
    Returns (state, diag, new caches)."""
    with admm.full_f32_matmul():
        return _multi_step(consts, cfg, state, scene, coupled, caches)


def _multi_step(consts, cfg, state, scene, coupled, caches=None):
    if caches is None:
        planes, plane_overflow = _all_planes(consts, cfg, state, scene)
    else:
        planes, plane_overflow, caches = _all_planes(consts, cfg, state, scene, caches)
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
    return (state, diag) if caches is None else (state, diag, caches)
