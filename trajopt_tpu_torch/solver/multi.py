"""Multi-robot consensus ADMM: decoupled and coupled-time modes.

Port of `trajopt_tpu/solver/multi.py`.  The robot axis U is a batch axis
written out: the per-robot gradients, Hessians, KKT systems, slack updates
and CCD tables of the whole fleet go through each op (and each kernel) in
one call.  Every `lax.cond` of its step is a `runtime.graph.device_cond` (a
Python branch, i.e. a host sync, in the host-stepped drivers; both sides
and a select in the fused drivers' CUDA graph): the live-pair gates of the
obstacle and pair planes, the plateau and GJK gates of both CCDs, the GJK
gate of each decoupled shrink round, and the coupled Armijo's step0 tests.
The decoupled shrink `while_loop` is `graph.fixed_rounds`, at most
``max_line_search`` guarded rounds.

Cross-robot coupling goes through four collectives, each taking
``axis_name``: a `torch.distributed` process group over which the robots
are sharded (`parallel.sharded`), or None for one process, where each is a
plain reduction: the hull all-gather of the pair planes and pair CCD, the
shared-time Schur sums and joint Armijo energies (coupled), the joint CCD
min (coupled), and the gnorm and diagnostics.  A predicate in front of a
branch that holds a collective is reduced over the group too (`_gany`), so
every rank takes the same branch; the others stay rank-local.

``interact=False``: the leading axis is an independent-scenario batch of
single robots sharing one scene, with no pair planes and no pair CCD
(`driver.solve_fused_batch`).  ``groups > 1``: the fleet is ``groups``
contiguous independent fleets of U/groups robots (`driver.
solve_fused_batch_multi`): pair planes and pair CCD are masked per group,
and in coupled mode the Schur sums, CCD min and Armijo are per group
(`_coupled_grouped_update`).  ``optimal_plane=True`` refines every obstacle
and robot-pair plane, and `multi_admm_step_cached` threads the persistent
plane caches of both.

State convention: a `SolverState` whose leaves carry a leading robot axis
U; ``piece_time`` is [U] in both modes (coupled keeps the entries equal, per
group when grouped).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
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


# ---------------------------------------------------------------------------
# Collectives over the robot group (``axis_name``; None = one process)
# ---------------------------------------------------------------------------


def _psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Elementwise sum over the group (``lax.psum``)."""
    if axis_name is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis_name)
    return out


def _gsum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Sum of every element on every rank."""
    return _psum(x.sum(), axis_name)


def _gany(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Any element true on any rank (an int max: no bool reduction in gloo)."""
    a = x.any()
    if axis_name is None:
        return a
    out = a.to(torch.int32)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis_name)
    return out > 0


def _gmin(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Least element on any rank."""
    out = x.amin()
    if axis_name is not None:
        dist.all_reduce(out, op=dist.ReduceOp.MIN, group=axis_name)
    return out


def _gather_robots(x: torch.Tensor, axis_name) -> torch.Tensor:
    """[U_local, ...] -> [U_total, ...] in rank order (identity for one
    process).  Every rank must hold the same U_local."""
    if axis_name is None:
        return x
    world = dist.get_world_size(axis_name)
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_single is the newer torch's name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=axis_name)
    return out


def _world(axis_name) -> int:
    return 1 if axis_name is None else dist.get_world_size(axis_name)


def _robot_ids(u_local: int, axis_name, device) -> torch.Tensor:
    """[U_local] fleet ids of this rank's robots (rank r holds the r-th
    contiguous block)."""
    offset = 0 if axis_name is None else dist.get_rank(axis_name) * u_local
    return torch.arange(offset, offset + u_local, device=device)


def init_multi_state(ops: sp.SplineOps, way_points_list, init_piece_time: float = 20.0,
                     *, device, dtype) -> SolverState:
    """Stacked per-robot initial states (multi layout)."""
    states = [init_state(ops, wp, init_piece_time, device=device, dtype=dtype, layout="multi")
              for wp in way_points_list]
    return SolverState(*(torch.stack(leaves) for leaves in zip(*states)))


def init_multi_caches(cfg: TrajOptConfig, consts: SplineConsts, u: int, *, device, dtype,
                      u_total: int | None = None) -> tuple[PlaneCache, PairPlaneCache]:
    """Empty persistent plane caches of a U-robot fleet (``optimal_plane=True``):
    the obstacle cache [U,P,R,K] and the pair cache [U,P,R,Ks].  ``u_total``:
    the whole fleet's size where these U robots are one rank's shard (the
    pair slots Ks count partners across the fleet)."""
    kw = dict(device=device, dtype=dtype)
    obs = empty_plane_cache(consts.piece_num, consts.res, cfg.max_planes, **kw)
    obs = PlaneCache(*(x.expand((u,) + x.shape).clone() for x in obs))
    ks = min(cfg.max_self_planes, max((u_total or u) - 1, 1))
    return obs, empty_pair_plane_cache(u, consts.piece_num, consts.res, ks, **kw)


# ---------------------------------------------------------------------------
# Inter-robot separating planes
# ---------------------------------------------------------------------------


def self_planes(consts: SplineConsts, cfg: TrajOptConfig, splines: torch.Tensor,
                cache: PairPlaneCache | None = None, axis_name=None, groups: int = 1):
    """Per-robot plane tables against the ``max_self_planes`` nearest other
    robots' hulls at each segment (K1), fitted as offset mid-planes by one
    fleet-wide GJK batch (K2) compacted to the ``self_plane_gjk_budget``
    nearest in-radius pairs, then the 1-D barrier Newton on the offset.
    ``splines`` are this rank's robots; the fleet's hulls are gathered over
    ``axis_name``.  With ``groups > 1`` robots pair only within their group.

    ``cache``: a pair whose partner has a cached midplane that both current
    hulls still clear by offset/2 starts from it (Optimization3D_multi.h:
    278-327); ``cfg.optimal_plane`` then refines every fitted midplane
    (`geometry.refine_pair_plane`, kept where finite).  Returns (planes
    [U,P,R,Ks,...], overflow), and with a cache the new one: the refined
    midplane of each live slot keyed by its partner."""
    u = splines.shape[0]
    hulls = en.seg_cps(consts, splines)                      # [U,P,R,n,3]
    all_hulls = _gather_robots(hulls, axis_name)             # [Ut,P,R,n,3]
    _, p, r, n, _ = hulls.shape
    ut = all_hulls.shape[0]
    ks = min(cfg.max_self_planes, max(ut - 1, 1))
    radius = cfg.offset + 2 * cfg.margin
    dtype, device = splines.dtype, splines.device

    lo_a, hi_a = bp.hull_aabbs(hulls)                        # [U,P,R,3]
    lo_b, hi_b = bp.hull_aabbs(all_hulls)                    # [Ut,P,R,3]
    gap = torch.maximum(lo_a[:, None] - hi_b[None], torch.clamp(lo_b[None] - hi_a[:, None], min=0.0))
    d2 = torch.sum(gap * gap, dim=-1)                        # [U,Ut,P,R]
    paired = ccd_ops.partners(_robot_ids(u, axis_name, device), ut, groups)
    d2 = torch.where(paired[:, :, None, None], d2, float("inf")).permute(0, 2, 3, 1).contiguous()
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
        other = all_hulls[idx, p_idx, r_idx]                 # [U,P,R,Ks,n,3]
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


def _fleet_hulls(consts, splines, directions, axis_name):
    """This rank's segment hulls and direction hulls, the fleet's (gathered
    over ``axis_name``), and this rank's fleet ids."""
    hulls = en.seg_cps(consts, splines)
    dhulls = en.seg_cps(consts, directions)
    gids = _robot_ids(splines.shape[0], axis_name, splines.device)
    return (hulls, dhulls, _gather_robots(hulls, axis_name), _gather_robots(dhulls, axis_name),
            gids)


def coupled_ccd_step(consts: SplineConsts, cfg: TrajOptConfig, splines, directions,
                     scene: Scene, axis_name=None, groups: int = 1) -> torch.Tensor:
    """One fleet-wide step (Step::couple_self_step + per-robot position_step):
    the obstacle and robot-pair analytic max-steps min-reduced over the
    fleet (over ``axis_name`` too), floored to the 0.8^k rung lattice.
    With ``groups > 1`` the fleet is ``groups`` independent coupled
    problems: a min and a rung floor per group, [groups]."""
    geo.check_gjk_route(cfg, splines.device)
    hulls, dhulls, all_hulls, all_dhulls, gids = _fleet_hulls(consts, splines, directions,
                                                              axis_name)
    s_obs = _obstacle_max_steps(cfg, hulls, dhulls, scene)
    s_pair = ccd_ops.pair_max_step_direct(
        hulls, dhulls, all_hulls, all_dhulls, gids, cfg.offset, cfg.gjk_iters,
        k_partners=max(1, 2 * cfg.max_self_planes), n_slots=cfg.ccd_pair_gjk_slots,
        groups=groups,
    )
    s_r = torch.minimum(s_obs, s_pair)                       # [U]
    if groups > 1:
        return admm.rung_floor(cfg, s_r.reshape(groups, -1).amin(dim=1))
    return admm.rung_floor(cfg, _gmin(s_r, axis_name))


def decoupled_ccd_steps(consts: SplineConsts, cfg: TrajOptConfig, splines, directions,
                        scene: Scene, axis_name=None, interact: bool = True,
                        groups: int = 1) -> torch.Tensor:
    """[U] per-robot steps: the pairwise shrink fixpoint (a robot whose
    pairs are not all certified shrinks by 0.8, at most ``max_line_search``
    rounds, then freezes at 0), min the per-robot rung-floored obstacle
    limit.  The rounds are `graph.fixed_rounds` (the reference's
    `while_loop`); each gathers the fleet's steps, so its predicate is any
    uncertified robot on any rank.  ``interact=False`` (a scenario batch)
    skips the fixpoint."""
    geo.check_gjk_route(cfg, splines.device)
    u = splines.shape[0]
    hulls, dhulls, all_hulls, all_dhulls, gids = _fleet_hulls(
        consts, splines, directions, axis_name if interact else None)
    steps = torch.ones((u,), dtype=splines.dtype, device=splines.device)
    if interact:
        tabs = ccd_ops.build_pair_ccd(hulls, dhulls, all_hulls, all_dhulls, gids,
                                      min(cfg.max_self_planes, max(all_hulls.shape[0] - 1, 1)),
                                      groups=groups)

        def bad_at(steps):
            return ccd_ops.pair_bad(tabs, steps, _gather_robots(steps, axis_name), cfg.offset,
                                    cfg.gjk_iters)

        def shrink(steps, bad):
            steps = torch.where(bad, steps * _SHRINK, steps)
            return steps, bad_at(steps)

        steps, bad = graph.fixed_rounds(cfg.max_line_search, lambda s, b: _gany(b, axis_name),
                                        shrink, steps, bad_at(steps))
        # robots still uncertified freeze at 0 (shrinking a robot's interval
        # only shrinks swept hulls, so this never invalidates another's)
        steps = torch.where(bad, torch.zeros_like(steps), steps)
    obs_steps = admm.rung_floor(cfg, _obstacle_max_steps(cfg, hulls, dhulls, scene))
    return torch.minimum(steps, obs_steps)


# ---------------------------------------------------------------------------
# Full iteration
# ---------------------------------------------------------------------------


def _all_planes(consts, cfg, state, scene, caches=None, axis_name=None, interact=True,
                groups=1):
    """Fleet plane tables (obstacle slots, then robot-pair slots) and the
    overflow flag, and with ``caches`` (obstacle `PlaneCache` [U,...],
    `PairPlaneCache`) the new caches.  The default obstacle tables compact
    the whole fleet's candidates into one budget (`separate_planes_batch`);
    with ``optimal_plane`` or caches each robot keeps its full table (the
    cache slots align with it), all robots in one GJK batch.
    ``interact=False`` (a scenario batch): no robot-pair planes."""
    multi = interact and (state.spline.shape[0] > 1 or axis_name is not None)
    pair = dict(axis_name=axis_name, groups=groups)
    if caches is not None:
        obs_cache, pair_cache = caches
        obstacle, overflow, obs_cache = admm.separate_planes(
            consts, cfg, state.spline, scene, obs_cache)
        if multi:
            slf, self_overflow, pair_cache = self_planes(consts, cfg, state.spline, pair_cache,
                                                         **pair)
            return (concat_planes(obstacle, slf), overflow | self_overflow,
                    (obs_cache, pair_cache))
        return obstacle, overflow, (obs_cache, pair_cache)
    if cfg.optimal_plane:
        obstacle, overflow = admm.separate_planes(consts, cfg, state.spline, scene)
    else:
        obstacle, overflow = admm.separate_planes_batch(consts, cfg, state.spline, scene)
    if multi:
        slf, self_overflow = self_planes(consts, cfg, state.spline, **pair)
        return concat_planes(obstacle, slf), overflow | self_overflow
    return obstacle, overflow


def _directions(consts, cfg, state, planes):
    """Per-robot reduced KKT solves on the stacked [U, ...] blocks: one PSD
    repair (`gradients.apply_psd_repair`) over all U*P pieces, one fused
    factor and solve (K3 + K4 in one launch) over the U systems."""
    g, h = gr.piece_grads_and_hessians(
        consts, cfg, state.spline, state.piece_time, planes,
        state.p_slack, state.t_slack, state.p_lambda, state.t_lambda, repair=False,
    )
    red = kkt.assemble_reduced(consts, g, gr.apply_psd_repair(cfg, h))
    return kkt.local_solve(red), red


def _coupled_update(consts, cfg, state, planes, ls, red, scene, axis_name=None):
    """Shared-time spline update (Optimization3D_multi.h:120-174): the Schur
    scalars, the CCD min and the Armijo energies are summed (or min-reduced)
    over the fleet, across ``axis_name`` too."""
    u = state.spline.shape[0]
    u_total = u * _world(axis_name)
    s_tot = _gsum(ls.schur_s, axis_name)
    ds, dt = kkt.finish_direction(ls, s_tot, _gsum(ls.schur_r, axis_name))   # dt [U]
    # one iterative-refinement round (f32 Schur cancellation guard)
    _, rt_local, ainv_rs = kkt.correct_direction(red, ls, ds, dt)
    br = _gsum(torch.einsum("ui,ui->u", red.b, ainv_rs), axis_name)
    s_safe = torch.maximum(s_tot, 1e-5 * torch.clamp(s_tot.abs(), min=1.0))
    cdt = -(_gsum(rt_local, axis_name) - br) / s_safe
    ds = ds + (-ainv_rs - cdt * ls.ainv_b)
    dt = dt + cdt
    gt_tot = _gsum(red.gt, axis_name)
    wolfe = -(_gsum(torch.einsum("ui,ui->u", ds, red.gs), axis_name) + dt[0] * gt_tot)
    # steepest-descent fallback, NaN-proof
    finite = torch.isfinite(wolfe) & torch.all(torch.isfinite(ds)) & torch.all(torch.isfinite(dt))
    bad = ~finite | ~(wolfe > 0)
    gs2 = _gsum(torch.sum(red.gs ** 2, dim=1), axis_name)
    ds = torch.where(bad, -red.gs, ds)
    dt = torch.where(bad, -gt_tot, dt)
    wolfe = torch.where(bad, gs2 + gt_tot ** 2, wolfe)
    directions = kkt.spread_direction(consts, ds)
    gnorm = torch.sqrt(gs2 + gt_tot ** 2) / u_total

    step0 = coupled_ccd_step(consts, cfg, state.spline, directions, scene, axis_name)
    t0 = state.piece_time[0]
    step0 = torch.where(t0 + step0 * dt[0] <= 0, -0.95 * t0 / dt[0], step0)
    ttab = en.build_trial_tables(consts, cfg, state, planes, directions, dt)

    def local_energy(step):
        return en.trial_energy(consts, cfg, ttab, step).sum()

    e0 = _psum(local_energy(torch.zeros((), dtype=t0.dtype, device=t0.device)), axis_name)
    e_step0 = _psum(local_energy(step0), axis_name)

    def armijo_ladder():
        ladder = admm.step_candidates(cfg, t0.dtype, t0.device) * step0   # [S]

        def eval_ok(sub):
            es = _psum(vmap(local_energy)(sub), axis_name)
            return admm.armijo_ok(e0, wolfe, sub, es), es

        ok, es = admm.staged_ladder_vals(eval_ok, ladder)
        i = admm._first_true(admm._with_floor_fallback(ok))[None]
        return ladder.gather(0, i)[0], es.gather(0, i)[0]

    # every input of the predicate is reduced over the group: one branch on every rank
    step, e_acc = graph.device_cond(admm.armijo_ok(e0, wolfe, step0, e_step0),
                                    lambda: (step0, e_step0), armijo_ladder)
    spline = state.spline + step * directions
    piece_time = state.piece_time + step * dt[0]
    return spline, piece_time, step.expand(u), step0.expand(u), gnorm, e_acc


def _coupled_grouped_update(consts, cfg, state, planes, ls, red, scene, groups):
    """Coupled spline update of a grouped fleet: ``groups`` independent
    coupled problems of U/groups robots each, in lockstep.  The fleet-wide
    reductions of `_coupled_update` (Schur sums, CCD min, Armijo energies)
    are per-group sums; the Armijo stage gates stay batch-global, so each is
    one branch for the whole batch.  The gnorm is the mean of the groups'."""
    u = state.spline.shape[0]
    upg = u // groups

    def gsum(x):                                             # [U] -> [G]
        return x.reshape(groups, upg).sum(dim=1)

    def rep(x):                                              # [G] -> [U]
        return x[:, None].expand(groups, upg).reshape(u)

    def first(x):                                            # [U] -> [G]
        return x.reshape(groups, upg)[:, 0]

    s_tot = gsum(ls.schur_s)
    ds, dt = kkt.finish_direction(ls, rep(s_tot), rep(gsum(ls.schur_r)))
    _, rt_local, ainv_rs = kkt.correct_direction(red, ls, ds, dt)
    br = gsum(torch.einsum("ui,ui->u", red.b, ainv_rs))
    s_safe = torch.maximum(s_tot, 1e-5 * torch.clamp(s_tot.abs(), min=1.0))
    cdt = -(gsum(rt_local) - br) / s_safe                    # [G]
    ds = ds + (-ainv_rs - rep(cdt)[:, None] * ls.ainv_b)
    dt = dt + rep(cdt)
    gt_g = gsum(red.gt)                                      # [G]
    dt_g = first(dt)
    wolfe = -(gsum(torch.einsum("ui,ui->u", ds, red.gs)) + dt_g * gt_g)   # [G]
    finite = (torch.isfinite(wolfe) & torch.isfinite(ds.reshape(groups, -1)).all(dim=1)
              & torch.isfinite(dt_g))
    bad = ~finite | ~(wolfe > 0)                             # [G]
    gs2 = gsum(torch.sum(red.gs ** 2, dim=1))
    ds = torch.where(rep(bad)[:, None], -red.gs, ds)
    dt = torch.where(rep(bad), -rep(gt_g), dt)
    wolfe = torch.where(bad, gs2 + gt_g ** 2, wolfe)
    dt_g = first(dt)
    directions = kkt.spread_direction(consts, ds)
    gnorm = torch.mean(torch.sqrt(gs2 + gt_g ** 2) / upg)

    step0 = coupled_ccd_step(consts, cfg, state.spline, directions, scene, groups=groups)
    t0_g = first(state.piece_time)
    step0 = torch.where(t0_g + step0 * dt_g <= 0, -0.95 * t0_g / dt_g, step0)   # [G]
    ttab = en.build_trial_tables(consts, cfg, state, planes, directions, dt)

    def group_energy(step_g):                                # [G] -> [G]
        return gsum(en.trial_energy(consts, cfg, ttab, rep(step_g)))

    e0 = group_energy(torch.zeros((groups,), dtype=dt.dtype, device=dt.device))
    e_step0 = group_energy(step0)
    accept0 = admm.armijo_ok(e0, wolfe, step0, e_step0)      # [G]

    def armijo_ladder():
        ladder = admm.step_candidates(cfg, dt.dtype, dt.device)[:, None] * step0[None, :]  # [S,G]

        def eval_ok(sub):
            es = vmap(group_energy)(sub)
            return admm.armijo_ok(e0, wolfe, sub, es), es

        ok, es = admm.staged_ladder_vals(eval_ok, ladder)
        i = admm._first_true(admm._with_floor_fallback(ok), dim=0)[None, :]
        return ladder.gather(0, i)[0], es.gather(0, i)[0].sum()

    step_g, e_acc = graph.device_cond(accept0.all(), lambda: (step0, e_step0.sum()),
                                      armijo_ladder)
    steps = rep(step_g)
    spline = state.spline + steps[:, None, None] * directions
    piece_time = state.piece_time + steps * dt
    return spline, piece_time, steps, rep(step0), gnorm, e_acc


def _decoupled_update(consts, cfg, state, planes, ls, red, scene, axis_name=None, interact=True,
                      groups=1):
    """Per-robot-time spline update (Optimization3D_multi.h:29-118): each
    robot's own Newton direction, CCD step and Armijo rung; the gnorm is the
    mean over the fleet (across ``axis_name`` too)."""
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
    gnorm = _gsum(ls.gnorm, axis_name) / (u * _world(axis_name))

    ccd_steps = decoupled_ccd_steps(consts, cfg, state.spline, directions, scene, axis_name,
                                    interact=interact, groups=groups)
    step0 = torch.where(state.piece_time + ccd_steps * dt <= 0,
                        -0.95 * state.piece_time / dt, ccd_steps)
    ttab = en.build_trial_tables(consts, cfg, state, planes, directions, dt)

    def robot_energy(step_vec):
        return en.trial_energy(consts, cfg, ttab, step_vec)

    e0 = robot_energy(torch.zeros((u,), dtype=dt.dtype, device=dt.device))
    # parallel Armijo ladder per robot: [S, U]; its stage gates hold no
    # collective, so they stay rank-local
    ladder = admm.step_candidates(cfg, dt.dtype, dt.device)[:, None] * step0[None, :]
    ok = admm.staged_ladder_ok(
        vmap(lambda sv: admm.armijo_ok(e0, wolfe, sv, robot_energy(sv))), ladder
    )
    ok = admm._with_floor_fallback(ok)
    steps = torch.gather(ladder, 0, admm._first_true(ok, dim=0)[None, :])[0]
    spline = state.spline + steps[:, None, None] * directions
    piece_time = state.piece_time + steps * dt
    # diagnostic energy at the accepted steps, before the slack update
    e_acc = _gsum(robot_energy(steps), axis_name)
    return spline, piece_time, steps, ccd_steps, gnorm, e_acc


def multi_admm_step(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,          # leaves have a leading robot axis U
    scene: Scene,
    coupled: bool,
    axis_name=None,
    interact: bool = True,
    groups: int = 1,
) -> tuple[SolverState, StepDiag]:
    """One multi-robot ADMM iteration (coupled: Optimization3D_multi.h:120-174;
    decoupled: :29-118).  ``axis_name``: the process group the robots are
    sharded over (this rank's robots in ``state``; the diagnostics are the
    fleet's, equal on every rank), or None.  ``interact=False``: the leading
    axis is an independent-scenario batch sharing ``scene``.  ``groups``:
    that many contiguous independent fleets (U must divide evenly)."""
    with admm.full_f32_matmul():
        return _multi_step(consts, cfg, state, scene, coupled, axis_name=axis_name,
                           interact=interact, groups=groups)


def multi_admm_step_cached(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,
    scene: Scene,
    coupled: bool,
    caches: tuple[PlaneCache, PairPlaneCache],
    axis_name=None,
) -> tuple[SolverState, StepDiag, tuple[PlaneCache, PairPlaneCache]]:
    """`multi_admm_step` threading the persistent obstacle and pair plane
    caches (``optimal_plane=True`` semantics, Optimization3D_multi.h:278-327).
    Returns (state, diag, new caches)."""
    with admm.full_f32_matmul():
        return _multi_step(consts, cfg, state, scene, coupled, caches, axis_name=axis_name)


def _multi_step(consts, cfg, state, scene, coupled, caches=None, axis_name=None, interact=True,
                groups=1):
    u_total = state.spline.shape[0] * _world(axis_name)
    if groups < 1 or u_total % groups:
        # the reference assumes equal contiguous groups and fails late in a
        # reshape, or masks wrongly in decoupled mode
        raise ValueError(f"groups={groups} does not divide the fleet of {u_total} robots evenly")
    if coupled and groups > 1 and axis_name is not None:
        raise ValueError("grouped coupled batching is single-shard: axis_name must be None")
    if caches is None:
        planes, plane_overflow = _all_planes(consts, cfg, state, scene, axis_name=axis_name,
                                             interact=interact, groups=groups)
    else:
        planes, plane_overflow, caches = _all_planes(consts, cfg, state, scene, caches,
                                                     axis_name=axis_name)
    ls, red = _directions(consts, cfg, state, planes)
    if coupled and groups > 1:
        update = _coupled_grouped_update(consts, cfg, state, planes, ls, red, scene, groups)
    elif coupled:
        update = _coupled_update(consts, cfg, state, planes, ls, red, scene, axis_name)
    else:
        update = _decoupled_update(consts, cfg, state, planes, ls, red, scene, axis_name,
                                   interact, groups)
    spline, piece_time, steps, ccd_steps, gnorm, e_acc = update
    state, residual = admm.slack_update(
        consts, cfg, state._replace(spline=spline, piece_time=piece_time)
    )
    diag = StepDiag(
        gnorm=gnorm,
        consensus_residual=torch.sqrt(_gsum(residual ** 2, axis_name)),
        step=_gmin(steps, axis_name),
        ccd_step=_gmin(ccd_steps, axis_name),
        n_planes=_gsum(planes.mask, axis_name),
        energy=e_acc,
        infeasible=~torch.isfinite(e_acc),
        plane_overflow=_gany(plane_overflow, axis_name),
    )
    return (state, diag) if caches is None else (state, diag, caches)
