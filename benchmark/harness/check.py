"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the window answered, drawn from the seed with the one that
took most iterations in it, is solved again by the plain reference
(`reference`, a frozen plain-PyTorch copy of the solver) in float64, from
the same host-side cloud and waypoints.  Every answer the window gave to a
sampled request is held to that solve.  The numbers compared, each the
worst over those answers and, in a fleet, over the robots:

- ``iters_gap``: iterations, the program's against the reference's;
- ``time_gap``: |piece time - the reference's| / the reference's (the
  plan's duration, ``ccd_time`` up to a constant);
- ``len_gap``: the same for the curve's length (``ccd_len``, by the
  frozen quality arithmetic `reference.metrics`);
- ``path_gap``: the largest distance between a control point and the
  reference's, over the reference's curve length;
- ``clearance``: the least distance from the densely sampled curve to the
  cloud (`curve_clearance`), held to the
  configuration's ``offset``, the clearance every plan guarantees;
- ``pair_clearance`` (fleets): the least distance between two robots'
  control hulls at equal segment index (exact GJK in float64), held to
  ``offset`` less the float32 slack the configuration states.

Each limit is in the configuration's file (``check.limits``): ``max`` for a
gap, ``min`` for a clearance.  The reference imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import random

import numpy as np
import torch
from scipy.spatial import cKDTree

from reference import admm as ref_admm
from reference import energies as ref_en
from reference import geometry as ref_geo
from reference import metrics as ref_metrics
from reference import multi as ref_multi
from reference import solve as ref_solve
from reference import splines as ref_sp
from reference import types as ref_types
from reference.config import TrajOptConfig

NUMBERS = ("iters_gap", "time_gap", "len_gap", "path_gap", "clearance", "pair_clearance")


@dataclasses.dataclass
class Plan:
    iterations: int
    spline: np.ndarray      # [U, T, 3]
    piece_time: np.ndarray  # [U]


def as_plan(iterations, spline, piece_time) -> Plan:
    spline = np.asarray(spline, dtype=np.float64)
    return Plan(int(iterations), spline if spline.ndim == 3 else spline[None],
                np.atleast_1d(np.asarray(piece_time, dtype=np.float64)))


def sample(answers, seed: int, size: int) -> list[int]:
    """Pool indices to check: the request of the answer with most
    iterations, and ``size - 1`` others drawn from ``seed``."""
    indices = sorted({a.index for a in answers})
    longest = max(answers, key=lambda a: a.iterations).index
    rest = [i for i in indices if i != longest]
    return [longest] + random.Random(seed).sample(rest, min(size - 1, len(rest)))


def _tf32(on: bool) -> None:
    """TF32 matmuls on or off, by every switch torch has for them."""
    torch.set_float32_matmul_precision("high" if on else "highest")
    matmul = torch.backends.cuda.matmul
    if hasattr(matmul, "fp32_precision"):
        matmul.fp32_precision = "tf32" if on else "ieee"
    else:
        matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def precision(name: str):
    """The reference's arithmetic: "float64"; "float32" (TF32 off, the
    configuration's own); "tf32", float32 with TF32 matmuls allowed (the
    step's own scoping of full float32, `admm.full_f32_matmul`, is replaced
    for it); or "bfloat16", the control.  The caller's settings are restored
    after it."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
             ref_admm.full_f32_matmul)
    tf32 = name == "tf32"

    @contextlib.contextmanager
    def scoped():
        _tf32(tf32)
        yield

    _tf32(tf32)
    ref_admm.full_f32_matmul = scoped
    try:
        yield {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(name, torch.float32)
    finally:
        _tf32(False)
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
        ref_admm.full_f32_matmul = saved[2]


def curve_clearance(ops, spline: np.ndarray, tree, piece_time: float) -> float:
    """`reference.metrics.min_curve_clearance` (the same curve samples, dt
    0.02) with the nearest cloud point from a k-d tree instead of every
    distance in blocks."""
    pts = ref_metrics.sample_trajectory(ops, spline, piece_time, dt=0.02)
    return float(tree.query(pts)[0].min())


class Reference:
    """The plain reference for one configuration."""

    def __init__(self, config: dict, device: str):
        self.config, self.device = config, device
        self.cfg = TrajOptConfig(**config["solver"])
        self.ops = ref_sp.build_spline_ops(config["n_pieces"], self.cfg.res)

    def solve(self, request, name: str = "float64") -> Plan:
        """The request solved again from its cloud and waypoints."""
        cfg, config = self.cfg, self.config
        with precision(name) as dtype:
            kw = dict(device=self.device, dtype=dtype)
            consts = ref_types.device_consts(self.ops, **kw)
            scene = ref_types.make_scene(request.cloud, **kw)
            if config["robots"] == 1:
                state = ref_types.init_state(self.ops, request.waypoints, cfg.init_piece_time, **kw)
                coupled = None
            else:
                state = ref_multi.init_multi_state(self.ops, request.waypoints,
                                                   cfg.init_piece_time, **kw)
                coupled = config["coupled"]
            state, it, _ = ref_solve.solve(consts, cfg, state, scene, coupled=coupled,
                                           max_iters=cfg.max_iters)
            return as_plan(it, state.spline.double().cpu().numpy(),
                           state.piece_time.double().cpu().numpy())

    def pair_clearance(self, plan: Plan) -> float:
        """Least hull-hull distance between two robots at equal segment index."""
        if plan.spline.shape[0] < 2:
            return math.inf
        kw = dict(device=self.device, dtype=torch.float64)
        consts = ref_types.device_consts(self.ops, **kw)
        hulls = ref_en.seg_cps(consts, torch.as_tensor(plan.spline, **kw))  # [U,P,R,n,3]
        u, n = hulls.shape[0], hulls.shape[-2]
        iu, ju = torch.triu_indices(u, u, 1, device=hulls.device)
        a, b = hulls[iu].reshape(-1, n, 3), hulls[ju].reshape(-1, n, 3)
        d = ref_geo.origin_simplex_dist(ref_geo.minkowski_diff(a, b), 48).dist
        return float(d.min())

    def numbers(self, plan: Plan, ref: Plan, cloud: np.ndarray) -> dict:
        """The compared numbers of one answer (or of the control's plan)."""
        ops = self.ops
        out = {"iters_gap": float(abs(plan.iterations - ref.iterations))}
        if not (np.isfinite(plan.spline).all() and np.isfinite(plan.piece_time).all()):
            out.update({k: math.inf for k in ("time_gap", "len_gap", "path_gap")},
                       clearance=-math.inf, pair_clearance=-math.inf)
            return out
        time_gap = len_gap = path_gap = 0.0
        clearance = math.inf
        tree = cKDTree(cloud)
        for u in range(ref.spline.shape[0]):
            length = ref_metrics.trajectory_stats(ops, ref.spline[u], ref.piece_time[u])["ccd_len"]
            mine = ref_metrics.trajectory_stats(ops, plan.spline[u], plan.piece_time[u])["ccd_len"]
            time_gap = max(time_gap, abs(plan.piece_time[u] - ref.piece_time[u]) / ref.piece_time[u])
            len_gap = max(len_gap, abs(mine - length) / length)
            path_gap = max(path_gap, float(np.linalg.norm(plan.spline[u] - ref.spline[u],
                                                          axis=-1).max()) / length)
            clearance = min(clearance, curve_clearance(ops, plan.spline[u], tree,
                                                       plan.piece_time[u]))
        out.update(time_gap=float(time_gap), len_gap=float(len_gap), path_gap=path_gap,
                   clearance=clearance)
        if plan.spline.shape[0] > 1:
            out["pair_clearance"] = self.pair_clearance(plan)
        return out


def worst(rows: list[dict]) -> dict:
    """The worst of each number over answers: the largest gap, the least
    clearance."""
    out = {}
    for key in NUMBERS:
        vals = [r[key] for r in rows if key in r]
        if vals:
            out[key] = min(vals) if key.endswith("clearance") else max(vals)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is not finite where a gap is, or is missing, fails."""
    checks, ok = {}, True
    for key, limit in limits.items():
        value = values.get(key)
        if value is None:
            continue
        if "max" in limit:
            good = value <= limit["max"]
        else:
            good = value >= limit["min"]
        ok = ok and bool(good)
        checks[key] = {"value": value, "limit": limit}
    return ok, checks
