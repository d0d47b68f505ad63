"""Problem configuration for the TPU-native consensus-ADMM trajectory optimizer.

Replaces the mutable-global configuration of the reference implementation
(`reference/HighOrderCCD/Utils/CCDUtils.h:36-82`, parsed from
`Config File/3D.json` in `Main/admmPathPlanning3D.cpp:368-397`) with a single
immutable dataclass.  Every knob of the reference — including the ones it
hard-codes in its `main()`s (`ks`, `kt`, initial `piece_time`, `uav_num`) — is
an explicit field here.

Static shape parameters (`order`, `der`, `res`, `max_planes`, ...) are traced
as Python constants so everything downstream jit-compiles with static shapes.

The torch port's own copy of `trajopt_tpu/config.py`, identical apart from import
paths (and the C++ reference's file paths written relative to its root):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

ORDER = 5  # quintic Bezier             (reference: CCDUtils.h:31 `order_num`)
DER = 3    # jerk minimization          (reference: CCDUtils.h:32 `der_num`)


@dataclasses.dataclass(frozen=True)
class TrajOptConfig:
    # --- knobs from Config_File/3D.json (same names where legal) -----------
    lam: float = 10.0          # "lambda": barrier weight
    epsilon: float = 0.1       # kept for config parity (unused by solver, as in reference)
    margin: float = 0.1        # barrier activation distance (d-hat)
    offset: float = 0.1        # hard clearance radius
    res: int = 8               # Bezier subdivisions per piece
    vel_limit: float = 2.0
    acc_limit: float = 2.0
    stop: float = 1e-2         # outer-loop gnorm threshold
    mu: float = 0.1            # ADMM penalty
    decouple: bool = True      # multi-robot: per-robot time vs shared time
    optimal_plane: bool = False
    init_mode: int = 1         # 1 = waypoint file, 2 = RRT planner
    init_ob: bool = True
    exit_on_converge: bool = False
    automove: bool = False
    gui: bool = False          # accepted for config parity; rendering is offline
    # --- values hard-coded in the reference mains --------------------------
    ks: float = 1e-8           # jerk weight   (admmPathPlanning3D.cpp:477; multi uses 1e-3)
    kt: float = 1.0            # time weight   (admmPathPlanning3D.cpp:478)
    init_piece_time: float = 20.0  # admmPathPlanning3D.cpp:482
    # --- TPU-build static-shape knobs (new; no reference equivalent) -------
    max_planes: int = 32       # K: separating-plane slots per subdivided segment
    max_self_planes: int = 8   # per-robot-pair plane slots per segment
    max_ccd_candidates: int = 32  # obstacle candidates per segment for the CCD clamp
    # GJK slots per separate-phase dispatch: the plane generators compact the
    # in-radius (segment, obstacle) / (segment, robot-pair) candidates to this
    # many nearest pairs before the batched GJK + plane fit (fleet-wide in
    # multi mode).  Overflow (more live candidates than slots) is surfaced in
    # StepDiag.plane_overflow and as a driver warning — raise the budget for
    # dense scenes.
    plane_gjk_budget: int = 1024
    self_plane_gjk_budget: int = 1024
    max_line_search: int = 64  # cap on 0.8^k shrinks (0.8^64 ~ 6e-7)
    # GJK-refinement slots per segment in the analytic max-step CCD
    # (ops/ccd.py::*_max_step_direct level 3): the S smallest analytic
    # limits per segment get an exact GJK + Lipschitz lift, the (S+1)-th
    # analytic value caps the result.  Larger = more escape capacity in
    # congestion, smaller = less GJK work per step.
    ccd_gjk_slots: int = 8
    ccd_pair_gjk_slots: int = 4
    # Dangerous-segment budget of the obstacle CCD (ops/ccd.py::
    # obstacle_max_step_direct): levels 2-3 refine only the W segments with
    # the smallest level-1 analytic limits; every other segment keeps its own
    # exact level-1 limit (sound — never a cap).  Measured danger counts on
    # the 64-robot bench peak at 14 of 2048 segments, so 64 is ~5x headroom;
    # raising it only costs speed.
    ccd_seg_budget: int = 64
    gjk_iters: int = 24        # Frank-Wolfe iterations in the device GJK kernel
    use_pallas_gjk: bool | None = None  # None = auto (TPU + float32)
    max_iters: int = 1_000_000
    # PSD repair of the per-piece Newton blocks (Gradient_admm.h:40-53):
    #   "gmw"    — GMW81 modified Cholesky (default; kernel K3, ops/cuda_chol.py),
    #   "eigh"   — reference-exact minimal spectrum shift (eigenvalues by
    #              kernel K6, ops/cuda_eig.py),
    #   "ladder" — Cholesky shift ladder (K3's plain mode as the PD test).
    # Each runs in every driver; any other name raises ValueError.
    psd_method: str = "gmw"
    # "analytic": closed-form batched spline grad/Hessian einsums (default,
    #   ops/gradients.py::analytic_spline_gh); "autodiff": jacfwd(grad) oracle
    grad_mode: str = "analytic"
    broadphase_coarse_k: int = 64  # two-level broad phase subset (0 = direct)
    # Dangerous-piece budget of the fleet-batched broad phase
    # (ops/broadphase.py::fleet_candidates): only the Wp pieces nearest the
    # cloud run the coarse top-k; pieces farther than the query radius have
    # no candidate by construction (exact).  Overflow -> plane_overflow
    # telemetry.  0 disables the compaction (per-robot topk_candidates).
    broadphase_piece_budget: int = 32

    @property
    def order(self) -> int:
        return ORDER

    @property
    def der(self) -> int:
        return DER

    @classmethod
    def from_json(cls, path: str, **overrides: Any) -> "TrajOptConfig":
        """Load a reference-format `3D.json` config file.

        Field mapping follows `Main/admmPathPlanning3D.cpp:372-397`.
        """
        with open(path) as f:
            j = json.load(f)
        kw: dict[str, Any] = {}
        m = {
            "lambda": ("lam", float),
            "epsilon": ("epsilon", float),
            "margin": ("margin", float),
            "offset": ("offset", float),
            "res": ("res", int),
            "vel_limit": ("vel_limit", float),
            "acc_limit": ("acc_limit", float),
            "stop": ("stop", float),
            "mu": ("mu", float),
            "decouple": ("decouple", lambda v: bool(int(v))),
            "optimal_plane": ("optimal_plane", lambda v: bool(int(v))),
            "init": ("init_mode", int),
            "init_ob": ("init_ob", lambda v: bool(int(v))),
            "exit": ("exit_on_converge", lambda v: bool(int(v))),
            "auto": ("automove", lambda v: bool(int(v))),
            "gui": ("gui", lambda v: bool(int(v))),
        }
        for key, (field, conv) in m.items():
            if key in j:
                kw[field] = conv(j[key])
        kw.update(overrides)
        return cls(**kw)

    def replace(self, **kw: Any) -> "TrajOptConfig":
        return dataclasses.replace(self, **kw)
