"""Single-robot consensus-ADMM iteration.

Port of `trajopt_tpu/solver/admm.py`.  One `admm_step` runs the
reference's three phases: separating-plane generation, the spline Newton
step with a CCD-clamped Armijo line search, and the per-piece slack Newton
step with dual ascent; `admm_step_cached` also threads the persistent plane
cache of ``optimal_plane=True``.  Each `lax.cond` of the JAX step is a
`runtime.graph.device_cond`: `armijo_spline` (step0 accepted?), each further
stage of a staged ladder, the fleet's live-candidate gate and the gates
inside the CCD.  In the host-stepped drivers each is a Python branch (one
device-to-host sync); in the fused drivers' CUDA graph, an IF node.

Under the tracing switch (`runtime.trace.on`) the step marks where each of
its phases starts (`trace.PHASES`: planes, direction, ccd, armijo, slack,
diag) and where it ends, and counts its planes, the Armijo trial
energies it evaluates, the slack ladder's accepted rungs and the
directions that took the steepest-descent fallback.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.func import vmap

from ..config import TrajOptConfig
from ..ops import broadphase as bp
from ..ops import ccd as ccd_ops
from ..ops import cuda_chol
from ..ops import cuda_direction
from ..ops import cuda_slack
from ..ops import cuda_topk
from ..ops import energies as en
from ..ops import geometry as geo
from ..ops import gradients as gr
from ..ops import kkt
from ..runtime import graph, trace
from ..types import PlaneCache, Planes, Scene, SolverState, SplineConsts, StepDiag

_ARMIJO_C = 1e-4   # Optimization3D_admm.h:537
_SHRINK = 0.8      # Optimization3D_admm.h:542 / Step.h:97


@contextlib.contextmanager
def full_f32_matmul():
    """Full-float32 matmuls and convolutions (no TF32) inside the block, the
    caller's settings restored after it, as the reference scopes
    ``jax.default_matmul_precision("highest")`` to its step: the KKT blocks
    reach condition ~1e6 and reduced-precision passes give NaN Cholesky
    pivots."""
    precision = torch.get_float32_matmul_precision()
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


# ---------------------------------------------------------------------------
# Phase 1: separating planes
# ---------------------------------------------------------------------------


def _fit_obstacle_planes(cfg: TrajOptConfig, hull_f, pts_f):
    """Batched point-vs-hull GJK -> offset separating planes.
    ``hull_f`` [B,n,3], ``pts_f`` [B,3] -> (c [B,3], d [B], valid [B])."""
    geo.check_gjk_route(cfg, hull_f.device)
    diff = hull_f - pts_f[:, None, :]
    hd = geo.batched_origin_dist(diff, cfg.gjk_iters)
    vn = torch.clamp(hd.dist, min=1e-12)
    c = hd.v / vn[:, None]
    d = -torch.einsum("nd,nd->n", c, pts_f) - cfg.offset
    # near-contact feasibility clamp: under f32 the witness direction can
    # lose the last digits of "hull distance along c > offset" exactly when
    # hulls are a hair above offset; raising d only weakens the obstacle
    # side, keeps the plane active and the incumbent feasible
    s_min = torch.einsum("nmd,nd->nm", hull_f, c).amin(dim=1)
    d = torch.maximum(d, 1e-3 * cfg.margin - s_min)
    valid = hd.dist <= cfg.offset + cfg.margin
    return c, d, valid


def _planes_from_candidates(cfg: TrajOptConfig, hull, points, cand):
    """Planes for the candidate table ``cand`` ([S,...,K] over the segment
    hulls ``hull`` [S,n,3]): one flat GJK batch (K2) over the (segment,
    candidate) pairs, compacted to the ``plane_gjk_budget`` nearest in-radius
    pairs when the table is larger than the budget.  Returns flat (c [S*K,3],
    d [S*K], ok [S*K]) and the budget-overflow flag."""
    k = cand.idx.shape[-1]
    nf = hull.shape[0] * k
    budget = cfg.plane_gjk_budget
    flat_mask = cand.mask.reshape(-1)
    idx = cand.idx.reshape(-1)
    overflow = flat_mask.sum() > budget
    if nf <= budget:
        hull_f = torch.broadcast_to(hull[:, None], (hull.shape[0], k) + hull.shape[1:])
        c, d, valid = _fit_obstacle_planes(cfg, hull_f.reshape(nf, -1, 3), points[idx])
        return c, d, flat_mask & valid, overflow
    d2f = torch.where(flat_mask, cand.d2.reshape(-1), float("inf"))
    # the JAX step calls lax.top_k directly here (not the Pallas kernel)
    _, sel = cuda_topk.smallest_k_plain(d2f, budget)
    c, d, valid = _fit_obstacle_planes(cfg, hull[sel // k], points[idx[sel]])

    def scatter(x):
        return torch.zeros((nf,) + x.shape[1:], dtype=x.dtype, device=x.device).index_copy(0, sel, x)

    return scatter(c), scatter(d), scatter(flat_mask[sel] & valid), overflow


def separate_planes_batch(
    consts: SplineConsts, cfg: TrajOptConfig, splines: torch.Tensor, scene: Scene
) -> tuple[Planes, torch.Tensor]:
    """Fleet obstacle-plane tables with one GJK batch (K2) for all robots:
    the in-radius (segment, obstacle) candidates of the whole fleet compact
    to the ``plane_gjk_budget`` nearest.  ``splines`` [U,T,3] -> (planes
    [U,P,R,K,...], overflow).  The live-candidate gate is a `device_cond`."""
    hulls = en.seg_cps(consts, splines)                     # [U,P,R,n,3]
    radius = cfg.offset + cfg.margin
    if cfg.broadphase_coarse_k > 0 and cfg.broadphase_piece_budget > 0:
        cand, bp_overflow = bp.fleet_candidates(
            hulls, scene, radius, cfg.max_planes, coarse_k=cfg.broadphase_coarse_k,
            piece_budget=cfg.broadphase_piece_budget,
        )
    else:
        cand = bp.topk_candidates(hulls, scene, radius, cfg.max_planes,
                                  coarse_k=cfg.broadphase_coarse_k)
        bp_overflow = torch.zeros((), dtype=torch.bool, device=splines.device)
    shape = cand.mask.shape                                 # [U,P,R,K]

    def live():
        c, d, ok, overflow = _planes_from_candidates(
            cfg, hulls.reshape((-1,) + hulls.shape[-2:]), scene.points, cand
        )
        return (Planes(c=c.reshape(shape + (3,)), d=d.reshape(shape), mask=ok.reshape(shape)),
                overflow | bp_overflow)

    def dead():
        # no in-radius candidate fleet-wide: no GJK, no plane
        return Planes(c=splines.new_zeros(shape + (3,)), d=splines.new_zeros(shape),
                      mask=torch.zeros_like(cand.mask)), bp_overflow

    return graph.device_cond(cand.mask.any(), live, dead)


def separate_planes(
    consts: SplineConsts, cfg: TrajOptConfig, spline: torch.Tensor, scene: Scene,
    cache: PlaneCache | None = None,
):
    """Fixed-K separating-plane table for every subdivided segment and the
    budget-overflow flag; ``spline`` [..., T, 3] may carry leading robot
    axes.

    The default path compacts the GJK batch (`_planes_from_candidates`).
    With ``cfg.optimal_plane`` or a ``cache`` (a `types.PlaneCache` with the
    spline's leading axes) one GJK batch (K2) covers every (segment,
    candidate) slot, so that cache slots align with the candidate ids and
    nothing overflows; ``cfg.optimal_plane`` then refines every plane
    (`geometry.refine_plane`, kept where finite), warm-started from the
    cached normal where the slot's obstacle id was planed last iteration
    (the reference's persistent planes, Optimization3D_admm.h:126-193).
    Returns (planes, overflow) without a cache, else (planes, overflow,
    new_cache)."""
    hull = en.seg_cps(consts, spline)                       # [...,P,R,n,3]
    cand = bp.topk_candidates(hull, scene, cfg.offset + cfg.margin, cfg.max_planes,
                              coarse_k=cfg.broadphase_coarse_k)
    shape = cand.mask.shape                                 # [...,P,R,K]
    n = hull.shape[-2]
    if cache is None and not cfg.optimal_plane:
        c, d, ok, overflow = _planes_from_candidates(cfg, hull.reshape(-1, n, 3),
                                                     scene.points, cand)
        return Planes(c=c.reshape(shape + (3,)), d=d.reshape(shape),
                      mask=ok.reshape(shape)), overflow
    hull_f = torch.broadcast_to(hull[..., None, :, :], shape + (n, 3)).reshape(-1, n, 3)
    pts_f = scene.points[cand.idx.reshape(-1)]
    c, d, valid = _fit_obstacle_planes(cfg, hull_f, pts_f)
    if cfg.optimal_plane:
        if cache is not None:
            match = cand.idx[..., :, None] == cache.obs_id[..., None, :]   # [...,K,K]
            hit = match.any(-1)
            slot = torch.argmax(match.to(torch.uint8), dim=-1)            # first match
            warm = torch.gather(cache.c, -2, slot[..., None].expand(shape + (3,)))
            c = torch.where(hit.reshape(-1)[:, None], warm.reshape(-1, 3), c)
        c2, d2 = geo.refine_plane(hull_f, pts_f, c, cfg.offset, cfg.margin)
        good = torch.isfinite(c2).all(-1) & torch.isfinite(d2)
        c = torch.where(good[:, None], c2, c)
        d = torch.where(good, d2, d)
    mask = cand.mask & valid.reshape(shape)
    planes = Planes(c=c.reshape(shape + (3,)), d=d.reshape(shape), mask=mask)
    overflow = torch.zeros((), dtype=torch.bool, device=spline.device)
    if cache is None:
        return planes, overflow
    return planes, overflow, PlaneCache(obs_id=torch.where(mask, cand.idx, -1), c=planes.c)


# ---------------------------------------------------------------------------
# Phase 2: spline Newton + CCD clamp + Armijo
# ---------------------------------------------------------------------------


class SplineDirection(NamedTuple):
    direction: torch.Tensor    # [T,3]
    t_direction: torch.Tensor  # []
    wolfe: torch.Tensor        # []
    gnorm: torch.Tensor        # []


def spline_direction(
    consts: SplineConsts, cfg: TrajOptConfig, state: SolverState, planes: Planes
) -> SplineDirection:
    """Reduced Newton direction with one iterative-refinement round and a
    NaN-proof steepest-descent fallback.

    On the card, for one UAV under ``psd_method="gmw"`` and
    ``grad_mode="analytic"`` with a reduced system that factors densely
    (P <= 7; `cuda_direction.engages`), the phase is seven launches: the
    four of `ops/cuda_direction.py` around K3, K3+K4 and K4
    (`spline_direction_kernels`).  Everywhere else (the CPU, ``eigh`` and
    ``ladder``, ``grad_mode="autodiff"``, P >= 8) it is
    `spline_direction_plain`.  Counts an iteration whose direction took the
    fallback into the ``direction_fallbacks`` trace counter."""
    if not cuda_direction.engages(consts, cfg, state.spline):
        return spline_direction_plain(consts, cfg, state, planes)
    return spline_direction_kernels(consts, cfg, state, planes)


def spline_direction_kernels(
    consts: SplineConsts, cfg: TrajOptConfig, state: SolverState, planes: Planes
) -> SplineDirection:
    """`spline_direction` as the chain of `cuda_direction`'s four kernels
    and K3, K3+K4 and K4, each wrapper's plain version on the CPU (where
    the chain is `spline_direction_plain` bit for bit)."""
    g, h = cuda_direction.dir_grad_hess(consts, cfg, state, planes)
    _, e = cuda_chol.mod_chol(h, want_l=False)
    asm = cuda_direction.dir_assemble(consts, g, h, e)
    chol, _, x = cuda_chol.factor_solve(asm.a, asm.rhs)
    sch = cuda_direction.dir_schur(asm.red, x)
    fin = cuda_direction.dir_finish(consts, asm.red, sch, cuda_chol.chol_solve(chol, sch.r_s))
    trace.count("direction_fallbacks", lambda: fin.bad)
    return SplineDirection(*fin[:4])


def spline_direction_plain(
    consts: SplineConsts, cfg: TrajOptConfig, state: SolverState, planes: Planes
) -> SplineDirection:
    """`spline_direction` in plain PyTorch: the gradient and Hessian of
    ``cfg.grad_mode``, the PSD repair of ``cfg.psd_method``, the reduced KKT
    (one K3+K4 launch up to ns = 64, the block-tridiagonal factor above),
    one refinement round with K4 and the fallback."""
    g, h = gr.piece_grads_and_hessians(
        consts, cfg, state.spline, state.piece_time, planes,
        state.p_slack, state.t_slack, state.p_lambda, state.t_lambda,
    )
    red = kkt.assemble_reduced(consts, g, h)
    ls = kkt.local_solve(red)
    ds, dt = kkt.finish_direction(ls, ls.schur_s, ls.schur_r)
    rs, rt, ainv_rs = kkt.correct_direction(red, ls, ds, dt)
    fin = cuda_direction.dir_finish_plain(
        consts, red, cuda_direction.Schur(ls.ainv_b, ls.schur_s, ls.gnorm, ds, dt, rs, rt), ainv_rs)
    trace.count("direction_fallbacks", lambda: fin.bad)
    return SplineDirection(*fin[:4])


def armijo_ok(e0, wolfe, step, e):
    """The Armijo test of the spline line searches, for a feasible trial
    only: ``e`` finite and at most ``e0 - c * wolfe * step``.  The reference
    tests the inequality alone (`trajopt_tpu/solver/admm.py:471-474`), so
    where rounding leaves the current iterate infeasible (``e0`` = +inf, seen
    in float32) it accepts any trial, infeasible ones too, and the piece
    time collapses to NaN within a few iterations."""
    return torch.isfinite(e) & (e0 - _ARMIJO_C * wolfe * step >= e)


def step_candidates(cfg: TrajOptConfig, dtype, device, start=1.0) -> torch.Tensor:
    """The geometric step ladder start * 0.8^k, k = 0..max_line_search-1."""
    k = torch.arange(cfg.max_line_search, dtype=dtype, device=device)
    return start * torch.pow(torch.full((), _SHRINK, dtype=dtype, device=device), k)


def _first_true(ok: torch.Tensor, dim=0) -> torch.Tensor:
    """Index of the first True along ``dim`` (== its length if none)."""
    return torch.argmax(ok.to(torch.uint8), dim=dim) + torch.where(
        torch.any(ok, dim=dim), 0, ok.shape[dim]
    )


def staged_ladder_ok(eval_ok, ladder: torch.Tensor, stage: int = 8,
                     trials: str | None = None) -> torch.Tensor:
    """Test the first ``stage`` rungs; only if some column still lacks an
    accept, recurse on the tail with a doubled stage (8, 16, 32, ...).
    ``eval_ok(sub_ladder [M, ...]) -> bool [M, cols...]``.  ``trials``: the
    trace counter (`trace.count`) each stage run adds its rungs to."""
    return staged_ladder_vals(lambda sub: (eval_ok(sub),), ladder, stage, trials)[0]


def staged_ladder_vals(eval_fn, ladder: torch.Tensor, stage: int = 8,
                       trials: str | None = None) -> tuple:
    """The staged ladder of `staged_ladder_ok`, threading values beside the
    predicate: ``eval_fn(sub_ladder [M, ...]) -> (ok [M, cols...], *vals)``
    with each value shaped as ``ok``; a skipped stage gives False and +inf,
    so a chosen rung's values are always ones that were evaluated.  The
    stage gate is batch-global: every column must have an accept to skip
    the tail."""
    s = ladder.shape[0]
    n1 = min(stage, s)
    out1 = tuple(eval_fn(ladder[:n1]))
    if trials is not None:
        trace.count(trials, n1)
    if n1 == s:
        return out1
    ok1 = out1[0]
    shape = (s - n1,) + ok1.shape[1:]
    out2 = graph.device_cond(
        torch.all(torch.any(ok1, dim=0)),
        lambda: (torch.zeros(shape, dtype=torch.bool, device=ok1.device),) + tuple(
            torch.full(shape, float("inf"), dtype=v.dtype, device=v.device) for v in out1[1:]),
        lambda: staged_ladder_vals(eval_fn, ladder[n1:], 2 * stage, trials),
    )
    return tuple(torch.cat([a, b], dim=0) for a, b in zip(out1, out2, strict=True))


def _with_floor_fallback(ok: torch.Tensor) -> torch.Tensor:
    """Accept the last rung unconditionally (the ladder's floor)."""
    return torch.cat([ok[:-1], torch.ones_like(ok[-1:])], dim=0)


def rung_floor(cfg: TrajOptConfig, s: torch.Tensor) -> torch.Tensor:
    """Largest ladder rung 0.8^k (k < max_line_search) strictly below the
    certified limit ``s`` (0 if none)."""
    shrink = torch.full((), _SHRINK, dtype=s.dtype, device=s.device)
    k = torch.ceil(torch.log(torch.clamp(s, min=1e-30)) / torch.log(shrink))
    k = torch.clamp(k, min=0.0)
    step = shrink ** k
    # strict: a rung landing exactly on the supremum must shrink once more
    step = torch.where(step >= s, step * _SHRINK, step)
    return torch.where((s <= 0) | (k >= cfg.max_line_search), 0.0, step)


def ccd_step(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    spline: torch.Tensor,
    direction: torch.Tensor,
    scene: Scene,
) -> torch.Tensor:
    """Largest step 0.8^k whose swept control hulls provably keep clearance
    > offset from every obstacle point (Step::position_step)."""
    geo.check_gjk_route(cfg, spline.device)
    hull = en.seg_cps(consts, spline)[None]
    dhull = en.seg_cps(consts, direction)[None]
    s = ccd_ops.obstacle_max_step_direct(
        hull, dhull, scene.points, scene.mask, cfg.offset, cfg.gjk_iters,
        s1_slots=max(8, cfg.max_ccd_candidates),
        n_slots=cfg.ccd_gjk_slots, seg_budget=cfg.ccd_seg_budget,
    )[0]
    return rung_floor(cfg, s)


def armijo_spline(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,
    planes: Planes,
    sd: SplineDirection,
    step0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backtracking line search on the spline AL energy.
    Returns (spline', piece_time', step)."""
    t0, dt = state.piece_time, sd.t_direction
    step0 = torch.where(t0 + step0 * dt <= 0, -0.95 * t0 / dt, step0)

    state_u = SolverState(*(x[None] for x in state))
    planes_u = Planes(*(x[None] for x in planes))
    ttab = en.build_trial_tables(consts, cfg, state_u, planes_u, sd.direction[None], dt[None])

    def trial_energy(step):
        return en.trial_energy(consts, cfg, ttab, step[None])[0]

    e0 = trial_energy(torch.zeros((), dtype=t0.dtype, device=t0.device))

    def accepted(step):
        return armijo_ok(e0, sd.wolfe, step, trial_energy(step))

    def ladder():
        steps = step_candidates(cfg, t0.dtype, t0.device) * step0
        ok = _with_floor_fallback(staged_ladder_ok(vmap(accepted), steps,
                                                   trials="armijo_trials"))
        return steps.gather(0, _first_true(ok)[None])[0]

    trace.count("armijo_trials", 2)     # e0 and step0
    step = graph.device_cond(accepted(step0), lambda: step0, ladder)
    return state.spline + step * sd.direction, t0 + step * dt, step


# ---------------------------------------------------------------------------
# Phase 3: slack + dual update
# ---------------------------------------------------------------------------


def _slack_freeze_mask(piece_num: int, dtype, device) -> torch.Tensor:
    """[P,19] 1.0 for free local coords; the first piece freezes CP rows 0-1,
    the last rows n-1, n."""
    m = torch.ones((piece_num, gr.N_LOC), dtype=dtype, device=device)
    m[0, 0:6] = 0.0
    m[piece_num - 1, 12:18] = 0.0
    return m


def slack_update(
    consts: SplineConsts, cfg: TrajOptConfig, state: SolverState
) -> tuple[SolverState, torch.Tensor]:
    """Per-piece slack Newton + Armijo + dual ascent, batched over pieces.
    Returns (new_state, consensus_residual).

    The state may carry a leading robot axis U (the residual is then [U]):
    the pieces of all robots form one batch.  On the card, with the GMW
    repair and the closed-form Hessian (``psd_method="gmw"``,
    ``grad_mode="analytic"``), the whole phase is one launch of
    `cuda_slack.slack_step`; everywhere else (the CPU, ``eigh`` and
    ``ladder``, ``grad_mode="autodiff"``) it is `slack_update_plain`.
    Counts each piece's accepted rung index into the ``slack_rungs`` trace
    counter."""
    if (state.spline.device.type == "cuda" and cfg.psd_method == "gmw"
            and cfg.grad_mode == "analytic"):
        new_state, residual, rungs = cuda_slack.slack_step(consts, cfg, state)
        trace.count("slack_rungs", lambda: rungs.sum())
        return new_state, residual
    return slack_update_plain(consts, cfg, state)


def slack_update_plain(
    consts: SplineConsts, cfg: TrajOptConfig, state: SolverState
) -> tuple[SolverState, torch.Tensor]:
    """`slack_update` in plain PyTorch, the kernel's plain version: the
    slack energy's Hessian by `torch.func` (``vmap(jacfwd(grad))``), the
    PSD repair of ``cfg.psd_method`` and one fused K3 + K4 launch, and the
    staged Armijo ladder.  A ladder stage is evaluated when any piece of any
    robot still lacks an accepted rung, where the reference's vmapped
    `lax.cond` selects per robot; the first accepted rung of every piece is
    the same either way."""
    p_num = consts.piece_num
    lead = state.spline.shape[:-2]
    n_pc = state.t_slack.numel()                     # robots x pieces
    n_cp = gr.N_CP
    c_spline = torch.einsum(
        "pij,...pjd->...pid", consts.convert, en.piece_cps(consts, state.spline)
    ).reshape(n_pc, n_cp, 3)
    piece_time = torch.broadcast_to(state.piece_time[..., None], lead + (p_num,)).reshape(n_pc)
    p_slack0 = state.p_slack.reshape(n_pc, n_cp, 3)
    t_slack0 = state.t_slack.reshape(n_pc)
    p_lambda0 = state.p_lambda.reshape(n_pc, n_cp, 3)
    t_lambda0 = state.t_lambda.reshape(n_pc)
    xs = torch.cat([p_slack0.reshape(n_pc, -1), t_slack0[:, None]], dim=1)

    def local(x, cs, pt, pl, tl):
        return gr.local_slack_energy(x, cs, pt, pl, tl, consts.m_dyn, cfg)

    g, h = vmap(lambda *a: gr.grad_and_hess(local, *a))(
        xs, c_spline, piece_time, p_lambda0, t_lambda0
    )
    # freeze pinned end coords: zero their gradient, identity Hessian rows
    m = _slack_freeze_mask(p_num, xs.dtype, xs.device).repeat(n_pc // p_num, 1)
    g = g * m
    eye = torch.eye(gr.N_LOC, dtype=h.dtype, device=h.device)
    h = torch.where((m[:, :, None] * m[:, None, :]) > 0, h, eye[None])
    if cfg.psd_method != "gmw":
        # spectrum shift or shift ladder to PD, then the plain Cholesky
        # factor and solve in one launch (the reference's `smallchol.solve_pd`)
        h = gr.apply_psd_repair(cfg, h)
    # repair (GMW) + factor + solve in one launch on the card; the factor is not kept
    d = -cuda_chol.factor_solve(h.contiguous(), g.contiguous(), gmw=cfg.psd_method == "gmw",
                                want_l=False)[2]
    d = d * m
    wolfe = -torch.sum(d * g, dim=1)
    # NaN-proof steepest-descent fallback per piece
    bad = ~(torch.all(torch.isfinite(d), dim=1) & (wolfe > 0))
    d = torch.where(bad[:, None], -g, d)
    wolfe = torch.where(bad, torch.sum(g * g, dim=1), wolfe)

    d_cp = d[:, : 3 * n_cp].reshape(n_pc, n_cp, 3)
    d_t = d[:, 3 * n_cp]
    step = torch.ones((n_pc,), dtype=xs.dtype, device=xs.device)
    step = torch.where(t_slack0 + step * d_t <= 0, -0.95 * t_slack0 / d_t, step)

    e0 = en.slack_energy(consts, cfg, c_spline, piece_time, p_slack0, t_slack0,
                         p_lambda0, t_lambda0)

    def trial(step_vec):
        ev = en.slack_energy(
            consts, cfg, c_spline, piece_time,
            p_slack0 + step_vec[:, None, None] * d_cp, t_slack0 + step_vec * d_t,
            p_lambda0, t_lambda0,
        )
        return torch.where(torch.isnan(ev), float("inf"), ev)

    ladder = step_candidates(cfg, xs.dtype, xs.device)[:, None] * step[None, :]   # [S,U*P]
    ok = staged_ladder_ok(vmap(lambda sv: e0 - _ARMIJO_C * wolfe * sv >= trial(sv)), ladder)
    ok = _with_floor_fallback(ok)
    rung = _first_true(ok, dim=0)
    trace.count("slack_rungs", lambda: rung.sum())
    step = torch.gather(ladder, 0, rung[None, :])[0]

    p_slack = p_slack0 + step[:, None, None] * d_cp
    t_slack = t_slack0 + step * d_t
    p_lambda = p_lambda0 + cfg.mu * (c_spline - p_slack)
    t_lambda = t_lambda0 + cfg.mu * (piece_time - t_slack)
    per_robot = lead + (p_num,)
    residual = torch.sqrt(
        torch.sum(((c_spline - p_slack) ** 2).sum(dim=(1, 2)).reshape(per_robot), dim=-1)
        + torch.sum(((piece_time - t_slack) ** 2).reshape(per_robot), dim=-1)
    )
    new_state = state._replace(
        p_slack=p_slack.reshape(state.p_slack.shape), t_slack=t_slack.reshape(per_robot),
        p_lambda=p_lambda.reshape(state.p_lambda.shape), t_lambda=t_lambda.reshape(per_robot),
    )
    return new_state, residual


# ---------------------------------------------------------------------------
# Full iteration
# ---------------------------------------------------------------------------


def admm_step(
    consts: SplineConsts, cfg: TrajOptConfig, state: SolverState, scene: Scene
) -> tuple[SolverState, StepDiag]:
    """One full ADMM iteration (Optimization3D_admm::optimization)."""
    with full_f32_matmul():
        return _admm_step(consts, cfg, state, scene)


def admm_step_cached(
    consts: SplineConsts, cfg: TrajOptConfig, state: SolverState, scene: Scene,
    cache: PlaneCache,
) -> tuple[SolverState, StepDiag, PlaneCache]:
    """`admm_step` threading the persistent plane cache (``optimal_plane=True``
    semantics, CCDUtils.h:64-70)."""
    with full_f32_matmul():
        return _admm_step(consts, cfg, state, scene, cache)


def _admm_step(consts, cfg, state, scene, cache=None):
    trace.phase("planes")
    if cache is None:
        planes, overflow = separate_planes(consts, cfg, state.spline, scene)
    else:
        planes, overflow, cache = separate_planes(consts, cfg, state.spline, scene, cache)
    trace.phase("direction")
    sd = spline_direction(consts, cfg, state, planes)
    trace.phase("ccd")
    step_ccd = ccd_step(consts, cfg, state.spline, sd.direction, scene)
    trace.phase("armijo")
    spline, piece_time, step = armijo_spline(consts, cfg, state, planes, sd, step_ccd)
    state = state._replace(spline=spline, piece_time=piece_time)
    trace.phase("slack")
    state, residual = slack_update(consts, cfg, state)
    trace.phase("diag")
    ev = en.spline_energy(consts, cfg, state, planes)
    diag = StepDiag(
        gnorm=sd.gnorm,
        consensus_residual=residual,
        step=step,
        ccd_step=step_ccd,
        n_planes=planes.mask.sum(),
        energy=ev.value,
        infeasible=ev.infeasible,
        plane_overflow=overflow,
    )
    trace.count("planes", diag.n_planes)
    trace.phase("end")
    return (state, diag) if cache is None else (state, diag, cache)
