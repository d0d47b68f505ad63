"""The fused drivers' solve as a host loop.

`trajopt_tpu_torch/solver/driver.py::solve_fused` and `solve_fused_multi`
loop their step under the reference's rule ``(it < max_iters) & ((it <= 1)
| (gnorm >= stop))`` (Main/admmPathPlanning3D.cpp:504) and return (state,
iterations, final gnorm); this loop does the same with a read of gnorm
each iteration.
"""

from __future__ import annotations

import math

from . import admm, multi
from .config import TrajOptConfig
from .types import Scene, SolverState, SplineConsts


def solve(consts: SplineConsts, cfg: TrajOptConfig, state: SolverState, scene: Scene,
          coupled: bool | None = None, max_iters: int = 200
          ) -> tuple[SolverState, int, float]:
    """`admm.admm_step` (``coupled`` None) or `multi.multi_admm_step` until
    the stop rule ends the loop.  Returns (state, iterations, gnorm)."""
    it, gnorm = 0, math.inf
    while it < max_iters and (it <= 1 or gnorm >= cfg.stop):
        if coupled is None:
            state, diag = admm.admm_step(consts, cfg, state, scene)
        else:
            state, diag = multi.multi_admm_step(consts, cfg, state, scene, coupled)
        gnorm = float(diag.gnorm)
        it += 1
    return state, it, gnorm
