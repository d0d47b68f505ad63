"""Outer ADMM loop drivers.

Port of `trajopt_tpu/solver/driver.py`:

- host-stepped, `solve` and `solve_multi` with their start-up checks, the
  persistent plane caches of ``optimal_plane=True`` and checkpoint / resume
  (`runtime.checkpoint.CheckpointManager`).  Convergence gate: ``iter > 1
  and gnorm < stop``, exactly as the reference
  (Main/admmPathPlanning3D.cpp:504).  Each iteration reads its diagnostics
  to the host once, which also ends the iteration's device work before
  ``wall_ms`` is taken;
- fused, `solve_fused`, `solve_fused_multi` and `solve_fused_multi_cached`:
  the whole loop on the device (`runtime.graph.run_fused`: on the card one
  CUDA graph replayed, one host read of a flag per replay), with the
  reference's loop condition ``(it < max_iters) & ((it <= 1) | (gnorm >=
  stop))``.  They run the same step functions as the host-stepped drivers;
- scenario batches, `solve_fused_batch` (B single UAVs) and
  `solve_fused_batch_multi` (B fleets), through `solve_fused_multi`.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable

import numpy as np
import torch

from ..config import TrajOptConfig
from ..ops import broadphase as bp
from ..ops import cuda_gjk
from ..ops import energies as en
from ..ops import geometry as geo
from ..runtime import graph
from ..types import Scene, SolverState, SplineConsts, StepDiag, empty_plane_cache
from . import admm, multi


def initial_clearance(consts: SplineConsts, state: SolverState, scene: Scene) -> float:
    """Min distance from the initial control hulls to the obstacle cloud (the
    8 nearest points per segment box, 32 GJK iterations).  The solver needs
    a collision-free start with clearance > offset; this warns early instead
    of stalling silently at step 0."""
    hull = en.seg_cps(consts, state.spline)                 # [P,R,n,3]
    cand = bp.topk_candidates(hull, scene, radius=float("inf"), k=8)
    pts = scene.points[cand.idx]                            # [P,R,8,3]
    p, r, k, _ = pts.shape
    n = hull.shape[-2]
    diff = (hull[:, :, None] - pts[..., None, :]).reshape(p * r * k, n, 3)
    d = cuda_gjk.gjk_exact(diff.contiguous(), 32).dist
    return float(d.min())


def robot_pair_hulls(consts: SplineConsts, splines: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment hulls (a, b) [pairs*P*R, n, 3] of every robot pair i < j at
    equal segment index, for fleet splines [U,T,3]."""
    hulls = en.seg_cps(consts, splines)                     # [U,P,R,n,3]
    u, n = hulls.shape[0], hulls.shape[-2]
    iu, ju = torch.triu_indices(u, u, 1, device=hulls.device)
    return hulls[iu].reshape(-1, n, 3), hulls[ju].reshape(-1, n, 3)


def pair_hull_dist(consts: SplineConsts, spline: torch.Tensor) -> geo.HullDist:
    """Hull-hull distance of every robot pair at equal segment index
    [pairs*P*R] (exact GJK, K2; `geometry.batched_origin_dist` caps the 48
    iterations at 16, as the reference does)."""
    a, b = robot_pair_hulls(consts, spline)
    return geo.batched_origin_dist(geo.minkowski_diff(a, b), 48)


def initial_pair_clearance(consts: SplineConsts, state: SolverState) -> float:
    """Min hull-hull distance between robots at equal segment index, the
    quantity the pairwise CCD certifies against ``offset``."""
    if state.spline.shape[0] < 2:
        return float("inf")
    return float(pair_hull_dist(consts, state.spline).dist.min())


def warn_on_coarse_overflow(
    consts: SplineConsts, cfg: TrajOptConfig, spline: torch.Tensor, scene: Scene
) -> None:
    """One-time audit of the two-level broad phase: warn if a piece box holds
    more in-radius points than ``broadphase_coarse_k``."""
    if not cfg.broadphase_coarse_k:
        return
    hull = en.seg_cps(consts, spline)                       # [(U,)P,R,n,3]
    ov = bp.coarse_overflow(hull, scene, cfg.offset + cfg.margin, cfg.broadphase_coarse_k)
    if bool(ov.any()):
        warnings.warn(
            f"broad-phase coarse filter overflow: some piece boxes have more "
            f"than broadphase_coarse_k={cfg.broadphase_coarse_k} in-radius "
            "obstacle points; separating-plane quality may degrade — raise "
            "broadphase_coarse_k (or set it to 0 for the direct path)",
            stacklevel=3,
        )


def _warn_plane_overflow(cfg: TrajOptConfig, history: list) -> None:
    """One warning per solve when the plane-GJK compaction dropped live
    in-radius candidate pairs."""
    if history[-1]["plane_overflow"] and sum(1 for h in history if h["plane_overflow"]) == 1:
        warnings.warn(
            "separating-plane GJK budget overflow: more in-radius candidate "
            f"pairs than plane_gjk_budget={cfg.plane_gjk_budget} / "
            f"self_plane_gjk_budget={cfg.self_plane_gjk_budget} slots; "
            "overflow pairs get no barrier plane this iteration (CCD still "
            "prevents collisions) — raise the budget for dense scenes",
            stacklevel=3,
        )


def history_row(it: int, diag: StepDiag, piece_time: torch.Tensor, t0: float) -> dict:
    """One iteration's history record: the diagnostics in one device-to-host
    read, which also ends the iteration's device work before ``wall_ms``."""
    vals = torch.stack([
        diag.gnorm, diag.consensus_residual, diag.step, diag.ccd_step,
        diag.n_planes.to(diag.gnorm.dtype), diag.energy,
        torch.as_tensor(diag.plane_overflow, device=diag.gnorm.device).to(diag.gnorm.dtype),
        piece_time,
    ]).tolist()
    return {
        "iter": it,
        "gnorm": vals[0],
        "consensus_residual": vals[1],
        "step": vals[2],
        "ccd_step": vals[3],
        "n_planes": int(vals[4]),
        "energy": vals[5],
        "plane_overflow": bool(vals[6]),
        "piece_time": vals[7],
        "wall_ms": (time.perf_counter() - t0) * 1e3,
    }


def solve(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,
    scene: Scene,
    max_iters: int | None = None,
    callback: Callable[[int, StepDiag], None] | None = None,
    validate_init: bool = True,
    checkpointer=None,
) -> tuple[SolverState, list[dict]]:
    """Host-driven ADMM loop with per-iteration metrics (the same history
    keys as the JAX driver).  ``cfg.optimal_plane`` threads the persistent
    plane cache through `admm.admm_step_cached`.

    ``checkpointer``: a `runtime.checkpoint.CheckpointManager`; the loop
    resumes from its latest checkpoint (the iteration after it, with its
    gnorm and, under ``optimal_plane``, its plane cache) and offers each
    iteration's state to it."""
    max_iters = max_iters if max_iters is not None else cfg.max_iters
    if validate_init:
        clr = initial_clearance(consts, state, scene)
        if clr <= cfg.offset:
            warnings.warn(
                f"initial trajectory clearance {clr:.4f} <= offset "
                f"{cfg.offset}: the CCD safety clamp will block all motion "
                "(the solver, like the reference, requires a collision-free "
                "initialization — use the RRT planner or better waypoints)",
                stacklevel=2,
            )
        warn_on_coarse_overflow(consts, cfg, state.spline, scene)
    history: list[dict] = []
    cache = (empty_plane_cache(consts.piece_num, consts.res, cfg.max_planes,
                               device=state.spline.device, dtype=state.spline.dtype)
             if cfg.optimal_plane else None)
    it, gnorm, state, cache = _resume(checkpointer, cfg, state, cache, "single")
    while it < max_iters:
        if it > 1 and gnorm < cfg.stop:
            break
        t0 = time.perf_counter()
        if cache is None:
            state, diag = admm.admm_step(consts, cfg, state, scene)
        else:
            state, diag, cache = admm.admm_step_cached(consts, cfg, state, scene, cache)
        history.append(history_row(it, diag, state.piece_time, t0))
        gnorm = history[-1]["gnorm"]
        _warn_plane_overflow(cfg, history)
        if callback:
            callback(it, diag)
        if checkpointer is not None:
            checkpointer.maybe_save(it, state, extra={"gnorm": gnorm}, cache=cache)
        it += 1
    return state, history


def _resume(checkpointer, cfg: TrajOptConfig, state: SolverState, cache, kind: str):
    """(first iteration, gnorm, state, cache) to start a loop from: the
    latest checkpoint's, if there is one, else (0, inf) and the inputs.
    Under ``optimal_plane`` a saved cache of this ``kind`` ("single" or
    "multi") replaces the empty one, so refinement keeps accumulating."""
    restored = None if checkpointer is None else checkpointer.restore_latest_full(
        device=state.spline.device, dtype=state.spline.dtype)
    if restored is None:
        return 0, np.inf, state, cache
    state, meta, saved = restored
    if cfg.optimal_plane and meta.get("cache_kind") == kind:
        cache = saved
    return meta["step"] + 1, meta.get("extra", {}).get("gnorm", np.inf), state, cache


def solve_multi(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,          # leading robot axis U on all leaves
    scene: Scene,
    coupled: bool | None = None,
    max_iters: int | None = None,
    checkpointer=None,
    axis_name=None,
) -> tuple[SolverState, list[dict]]:
    """Host-driven multi-robot loop (coupled defaults to ``not cfg.decouple``),
    with the history keys of `solve`; ``piece_time`` is the fleet maximum.
    ``cfg.optimal_plane`` threads the obstacle and pair plane caches through
    `multi.multi_admm_step_cached`; ``checkpointer`` as in `solve`.

    ``axis_name``: the process group the robots are sharded over
    (`parallel.sharded`): ``state`` holds this rank's robots, the step's
    collectives run over the group, and the returned state is this rank's;
    the history is the fleet's, the same on every rank.  Checkpoints hold
    one process's fleet, so a sharded loop takes no ``checkpointer``."""
    coupled = (not cfg.decouple) if coupled is None else coupled
    max_iters = max_iters if max_iters is not None else cfg.max_iters
    if axis_name is not None and checkpointer is not None:
        raise ValueError("a sharded solve_multi takes no checkpointer: checkpoints hold one "
                         "process's whole fleet")
    warn_on_coarse_overflow(consts, cfg, state.spline, scene)
    fleet = state._replace(spline=multi._gather_robots(state.spline, axis_name))
    clr = initial_pair_clearance(consts, fleet)
    if clr <= cfg.offset:
        warnings.warn(
            f"initial min pairwise robot clearance {clr:.4f} <= offset "
            f"{cfg.offset}: the pairwise CCD clamp will freeze all motion at "
            "step 0 (the solver, like the reference's Step.h shrink loops, "
            "requires a collision-free initialization — separate the initial "
            "paths, e.g. by lane offsets or the RRT planner)",
            stacklevel=2,
        )
    history: list[dict] = []
    caches = (multi.init_multi_caches(cfg, consts, state.spline.shape[0],
                                      device=state.spline.device, dtype=state.spline.dtype,
                                      u_total=fleet.spline.shape[0])
              if cfg.optimal_plane else None)
    it, gnorm, state, caches = _resume(checkpointer, cfg, state, caches, "multi")
    while it < max_iters:
        if it > 1 and gnorm < cfg.stop:
            break
        t0 = time.perf_counter()
        if caches is None:
            state, diag = multi.multi_admm_step(consts, cfg, state, scene, coupled,
                                                axis_name=axis_name)
        else:
            state, diag, caches = multi.multi_admm_step_cached(
                consts, cfg, state, scene, coupled, caches, axis_name=axis_name)
        piece_time = multi._gather_robots(state.piece_time, axis_name).amax()
        history.append(history_row(it, diag, piece_time, t0))
        gnorm = history[-1]["gnorm"]
        _warn_plane_overflow(cfg, history)
        if checkpointer is not None:
            checkpointer.maybe_save(it, state, extra={"gnorm": gnorm}, cache=caches)
        it += 1
    return state, history


def fused_step(consts: SplineConsts, cfg: TrajOptConfig, scene: Scene,
               coupled: bool | None = None, cached: bool = False, **multi_options):
    """The step the fused drivers loop, ``step(carry) -> (carry, gnorm)``
    for `graph.run_fused` (and `graph.capture`): `admm.admm_step` on
    ``(state,)`` when ``coupled`` is None, else `multi.multi_admm_step`, or
    with ``cached`` `multi.multi_admm_step_cached` on ``(state, caches)``;
    ``multi_options`` (``axis_name``, ``interact``, ``groups``) go to the
    multi-robot step."""
    if coupled is None:
        def step(carry):
            new, diag = admm.admm_step(consts, cfg, carry[0], scene)
            return (new,), diag.gnorm
    elif cached:
        def step(carry):
            new, diag, caches = multi.multi_admm_step_cached(consts, cfg, carry[0], scene,
                                                             coupled, carry[1], **multi_options)
            return (new, caches), diag.gnorm
    else:
        def step(carry):
            new, diag = multi.multi_admm_step(consts, cfg, carry[0], scene, coupled,
                                              **multi_options)
            return (new,), diag.gnorm
    return step


def solve_fused(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,
    scene: Scene,
    max_iters: int = 200,
) -> tuple[SolverState, torch.Tensor, torch.Tensor]:
    """Entire solve as one device loop (`admm.admm_step` each iteration).
    Returns (state, iterations_run, final_gnorm), 0-d tensors on the
    state's device."""
    (state,), it, gnorm = graph.run_fused(fused_step(consts, cfg, scene), (state,), max_iters,
                                          cfg.stop)
    return state, it, gnorm


def solve_fused_multi(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,          # leading robot axis U on all leaves
    scene: Scene,
    coupled: bool,
    max_iters: int = 200,
    axis_name=None,
    interact: bool = True,
    groups: int = 1,
) -> tuple[SolverState, torch.Tensor, torch.Tensor]:
    """Entire multi-robot solve as one device loop
    (`multi.multi_admm_step`), the JAX package's production serving path.
    ``axis_name``: the process group the robots are sharded over (this
    rank's robots in ``state``; the step's collectives run inside the loop,
    and inside the CUDA graph on the card); ``interact`` and ``groups`` as
    in `multi.multi_admm_step` (`solve_fused_batch`,
    `solve_fused_batch_multi`).  Returns (state, iterations_run,
    final_gnorm)."""
    step = fused_step(consts, cfg, scene, coupled, axis_name=axis_name, interact=interact,
                      groups=groups)
    (state,), it, gnorm = graph.run_fused(step, (state,), max_iters, cfg.stop)
    return state, it, gnorm


def solve_fused_multi_cached(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,          # leading robot axis U on all leaves
    scene: Scene,
    coupled: bool,
    caches,                      # (obstacle PlaneCache [U,...], PairPlaneCache)
    max_iters: int = 200,
    axis_name=None,
):
    """`solve_fused_multi` with the persistent ``optimal_plane`` caches
    carried through the device loop (`multi.multi_admm_step_cached`; the
    plane tables accumulate across the whole run,
    Optimization3D_multi.h:278-327).  Returns (state, iterations_run,
    final_gnorm, caches)."""
    (state, caches), it, gnorm = graph.run_fused(
        fused_step(consts, cfg, scene, coupled, cached=True, axis_name=axis_name),
        (state, tuple(caches)), max_iters, cfg.stop)
    return state, it, gnorm, caches


def solve_fused_batch(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    states: SolverState,         # leading scenario axis B on all leaves
    scene: Scene,
    max_iters: int = 200,
) -> tuple[SolverState, torch.Tensor, torch.Tensor]:
    """B single-UAV scenarios sharing one scene as one fused device loop:
    the multi-robot step with ``interact=False`` (no pair planes, no pair
    CCD), so every kernel call takes the whole batch and the plane and CCD
    compaction pools candidates across it.  The loop stops on the mean
    gnorm over the scenarios, as the reference's batch driver does.
    Returns (states, iterations_run, final_mean_gnorm)."""
    return solve_fused_multi(consts, cfg, states, scene, coupled=False, max_iters=max_iters,
                             interact=False)


def solve_fused_batch_multi(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    states: SolverState,         # leading [B, U] scenario x robot axes
    scene: Scene,
    coupled: bool = True,
    max_iters: int = 200,
) -> tuple[SolverState, torch.Tensor, torch.Tensor]:
    """B independent U-robot fleets sharing one scene, advanced in lockstep
    in one fused device loop: [B, U] flattens into one fleet of ``groups=B``
    (pair planes and pair CCD masked per fleet; coupled, per-fleet Schur
    sums, CCD min and Armijo).  Returns (states [B, U, ...],
    iterations_run, final_mean_gnorm)."""
    b, u = states.spline.shape[:2]
    flat = SolverState(*(x.reshape((b * u,) + tuple(x.shape[2:])) for x in states))
    out, it, gnorm = solve_fused_multi(consts, cfg, flat, scene, coupled=coupled,
                                       max_iters=max_iters, groups=b)
    return SolverState(*(x.reshape((b, u) + tuple(x.shape[1:])) for x in out)), it, gnorm
