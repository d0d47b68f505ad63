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
  stop))``.  They run the same step functions as the host-stepped drivers.
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


def _history_row(it: int, diag: StepDiag, piece_time: torch.Tensor, t0: float) -> dict:
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
        history.append(_history_row(it, diag, state.piece_time, t0))
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
) -> tuple[SolverState, list[dict]]:
    """Host-driven multi-robot loop (coupled defaults to ``not cfg.decouple``),
    with the history keys of `solve`; ``piece_time`` is the fleet maximum.
    ``cfg.optimal_plane`` threads the obstacle and pair plane caches through
    `multi.multi_admm_step_cached`; ``checkpointer`` as in `solve`."""
    coupled = (not cfg.decouple) if coupled is None else coupled
    max_iters = max_iters if max_iters is not None else cfg.max_iters
    warn_on_coarse_overflow(consts, cfg, state.spline, scene)
    clr = initial_pair_clearance(consts, state)
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
                                      device=state.spline.device, dtype=state.spline.dtype)
              if cfg.optimal_plane else None)
    it, gnorm, state, caches = _resume(checkpointer, cfg, state, caches, "multi")
    while it < max_iters:
        if it > 1 and gnorm < cfg.stop:
            break
        t0 = time.perf_counter()
        if caches is None:
            state, diag = multi.multi_admm_step(consts, cfg, state, scene, coupled)
        else:
            state, diag, caches = multi.multi_admm_step_cached(
                consts, cfg, state, scene, coupled, caches)
        history.append(_history_row(it, diag, state.piece_time.amax(), t0))
        gnorm = history[-1]["gnorm"]
        _warn_plane_overflow(cfg, history)
        if checkpointer is not None:
            checkpointer.maybe_save(it, state, extra={"gnorm": gnorm}, cache=caches)
        it += 1
    return state, history


def _check_fused(cfg: TrajOptConfig) -> None:
    """Options the fused drivers refuse: ``psd_method="eigh"``, whose
    `torch.linalg.eigvalsh` waits on the host for its error check and so
    cannot run inside a CUDA graph (the host-stepped drivers take it)."""
    if cfg.psd_method == "eigh":
        raise NotImplementedError(
            "psd_method='eigh' is not available in the fused drivers: eigvalsh synchronizes "
            "with the host for its error check; use solve / solve_multi or psd_method='gmw'"
        )


def fused_step(consts: SplineConsts, cfg: TrajOptConfig, scene: Scene,
               coupled: bool | None = None, cached: bool = False):
    """The step the fused drivers loop, ``step(carry) -> (carry, gnorm)``
    for `graph.run_fused` (and `graph.capture`): `admm.admm_step` on
    ``(state,)`` when ``coupled`` is None, else `multi.multi_admm_step`, or
    with ``cached`` `multi.multi_admm_step_cached` on ``(state, caches)``."""
    _check_fused(cfg)
    if coupled is None:
        def step(carry):
            new, diag = admm.admm_step(consts, cfg, carry[0], scene)
            return (new,), diag.gnorm
    elif cached:
        def step(carry):
            new, diag, caches = multi.multi_admm_step_cached(consts, cfg, carry[0], scene,
                                                             coupled, carry[1])
            return (new, caches), diag.gnorm
    else:
        def step(carry):
            new, diag = multi.multi_admm_step(consts, cfg, carry[0], scene, coupled)
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
    axis_name: str | None = None,
    interact: bool = True,
    groups: int = 1,
) -> tuple[SolverState, torch.Tensor, torch.Tensor]:
    """Entire multi-robot solve as one device loop
    (`multi.multi_admm_step`), the JAX package's production serving path.
    ``axis_name`` (robot sharding), ``interact=False`` and ``groups > 1``
    are not ported and raise `NotImplementedError`.
    Returns (state, iterations_run, final_gnorm)."""
    if axis_name is not None:
        raise NotImplementedError("axis_name (robot sharding) is not ported to torch yet")
    if not interact:
        raise NotImplementedError("interact=False (scenario batches) is not ported to torch yet")
    if groups != 1:
        raise NotImplementedError("groups > 1 (grouped coupled fleets) is not ported to torch yet")
    (state,), it, gnorm = graph.run_fused(fused_step(consts, cfg, scene, coupled), (state,),
                                          max_iters, cfg.stop)
    return state, it, gnorm


def solve_fused_multi_cached(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    state: SolverState,          # leading robot axis U on all leaves
    scene: Scene,
    coupled: bool,
    caches,                      # (obstacle PlaneCache [U,...], PairPlaneCache)
    max_iters: int = 200,
    axis_name: str | None = None,
):
    """`solve_fused_multi` with the persistent ``optimal_plane`` caches
    carried through the device loop (`multi.multi_admm_step_cached`; the
    plane tables accumulate across the whole run,
    Optimization3D_multi.h:278-327).  Returns (state, iterations_run,
    final_gnorm, caches)."""
    if axis_name is not None:
        raise NotImplementedError("axis_name (robot sharding) is not ported to torch yet")
    (state, caches), it, gnorm = graph.run_fused(
        fused_step(consts, cfg, scene, coupled, cached=True), (state, tuple(caches)),
        max_iters, cfg.stop)
    return state, it, gnorm, caches
