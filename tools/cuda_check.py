"""On-card correctness record of the PyTorch/CUDA port: a congested mid-solve
float32 step on the card against the port's own CPU float64 oracle.

The CPU tests (tests/test_torch_*.py) hold the port to the JAX package in
float64, and `chip_smoke.py` holds each kernel to its plain version and
whole solves to the C++ rows.  A whole-solve gate can pass while a float32
direction error is absorbed by Armijo and extra iterations; this probe
checks one step, and it cannot pass vacuously:

1. Warm up the 8-robot coupled cross on the card until the solver is
   CONGESTED: separating planes live (``n_planes > 0``) and the coupled CCD
   limit below the full step (``ccd_step < 1``, so the level-2/3 k-DOP +
   GJK refinement of `ops/ccd.py` ran: the level-1 fast path fires only
   when every limit certifies 1).  With no such iteration in ``MAX_WARM``
   the probe raises.
2. From that warm state, compare the step quantities that have no
   data-dependent branch on the energy between the card (float32, kernels
   K1-K4 and the fused K3 + K4 launch; K6 under ``psd_method="eigh"``) and
   the same functions in CPU float64 (their plain versions): the corrected
   Newton direction (ds, dt), gnorm, the live plane count and the
   rung-floored coupled CCD limit.  The accepted Armijo rung is not
   compared: two rungs whose energies differ by less than float32 eps are
   both valid accepts (Optimization3D_admm.h:537-544).
3. Certify the card's post-step state in float64: min obstacle-hull and
   pair-hull clearance >= offset (exact GJK on every candidate), and a
   descent of the augmented-Lagrangian spline energy with the oracle's own
   planes.

``psd_method="ladder"`` is left out: its PD test picks a rung of the shift
ladder, which float32 and float64 may pick differently, so its direction is
not a quantity the two can agree on.

Usage, from the root of a checkout:

    python tools/cuda_check.py [--psd-method gmw|eigh] [--out FILE]   # on the card
    python tools/cuda_check.py --cpu      # the "card" side in CPU float32 (a rehearsal)

It prints one JSON line of the entries' ``ok`` values, then the report, and
exits non-zero when an entry fails.  Without a CUDA device and without
``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from trajopt_tpu_torch import types as tt  # noqa: E402
from trajopt_tpu_torch.config import TrajOptConfig  # noqa: E402
from trajopt_tpu_torch.ops import _cuda  # noqa: E402
from trajopt_tpu_torch.ops import broadphase as bp  # noqa: E402
from trajopt_tpu_torch.ops import energies as en  # noqa: E402
from trajopt_tpu_torch.ops import geometry as geo  # noqa: E402
from trajopt_tpu_torch.ops import kkt  # noqa: E402
from trajopt_tpu_torch.ops import splines as sp  # noqa: E402
from trajopt_tpu_torch.scenes import generators as gen  # noqa: E402
from trajopt_tpu_torch.solver import admm, multi  # noqa: E402

UAVS = 8
PIECES = 4
N_POINTS = 2000
MAX_WARM = 20
PSD_METHODS = ("gmw", "eigh")

DIRECTION_TOL = 5e-3       # ds, dt and gnorm, relative to the float64 value
PLANE_SLACK = 2            # live plane counts may differ by a flapping candidate
CLEARANCE_SLACK = 1e-5     # clearance >= offset - this
DESCENT_SLACK = 1e-6       # e_post <= e_warm + this * |e_warm|
NOT_ON_A_CARD = "not on a card"


class NotCongested(RuntimeError):
    """The warm-up never reached an iteration with live planes and a CCD
    limit below 1: the probe would be vacuous."""


def build(device, dtype, **cfg_options):
    """(cfg, consts, scene, state): `__graft_entry__._build_problem`'s 8-robot
    cross (2000 points, lane-assigned waypoints, 4 pieces, res 8, 16 planes,
    4 self planes, 16 CCD candidates); ``cfg_options`` go to the config."""
    cfg = TrajOptConfig(res=8, ks=1e-3, max_planes=16, max_self_planes=4, max_ccd_candidates=16,
                        **cfg_options)
    cloud = gen.cross_scene(n_points=N_POINTS, seed=0)
    wps = gen.assign_lanes(gen.cross_waypoints(UAVS, PIECES), cloud)
    ops = sp.build_spline_ops(PIECES, cfg.res)
    kw = dict(device=device, dtype=dtype)
    return (cfg, tt.device_consts(ops, **kw), tt.make_scene(cloud, **kw),
            multi.init_multi_state(ops, wps, cfg.init_piece_time, **kw))


def warm_to_congestion(consts, cfg, state, scene):
    """Coupled steps until the first with ``n_planes > 0`` and
    ``ccd_step < 1``.  Returns (the state before that step, its iteration,
    [(n_planes, ccd_step)] of every step taken); raises `NotCongested`
    when none of `MAX_WARM` steps is congested."""
    history = []
    for it in range(MAX_WARM):
        nxt, diag = multi.multi_admm_step(consts, cfg, state, scene, coupled=True)
        history.append((int(diag.n_planes), float(diag.ccd_step)))
        if history[-1][0] > 0 and history[-1][1] < 1.0:
            return state, it, history
        state = nxt
    raise NotCongested(
        f"no congested step in {MAX_WARM} iterations (n_planes > 0 and ccd_step < 1 never "
        f"held; (n_planes, ccd_step) per step: {history}): the check would be vacuous")


class Direction(NamedTuple):
    ds: torch.Tensor        # [U, ns] corrected free-coordinate direction
    dt: torch.Tensor        # [] shared time direction
    gnorm: torch.Tensor     # []
    n_planes: torch.Tensor  # [] live plane slots, obstacle and pair
    step0: torch.Tensor     # [] rung-floored coupled CCD limit
    planes: tt.Planes       # the fleet's plane tables


def direction_and_planes(cfg, consts, scene, state) -> Direction:
    """The coupled step's deterministic quantities from ``state``, as
    `multi._coupled_update` forms them (one iterative-refinement round, no
    steepest-descent fallback): the Newton direction, gnorm, the live planes
    and the coupled CCD limit; full float32 matmuls."""
    with admm.full_f32_matmul():
        planes, _ = multi._all_planes(consts, cfg, state, scene)
        ls, red = multi._directions(consts, cfg, state, planes)
        s_tot = ls.schur_s.sum()
        ds, dt = kkt.finish_direction(ls, s_tot, ls.schur_r.sum())
        _, rt_local, ainv_rs = kkt.correct_direction(red, ls, ds, dt)
        br = torch.einsum("ui,ui->u", red.b, ainv_rs).sum()
        s_safe = torch.maximum(s_tot, 1e-5 * torch.clamp(s_tot.abs(), min=1.0))
        cdt = -(rt_local.sum() - br) / s_safe
        ds = ds + (-ainv_rs - cdt * ls.ainv_b)
        dt = dt + cdt
        gnorm = torch.sqrt(torch.sum(red.gs ** 2) + red.gt.sum() ** 2) / state.spline.shape[0]
        directions = kkt.spread_direction(consts, ds)
        step0 = multi.coupled_ccd_step(consts, cfg, state.spline, directions, scene)
    return Direction(ds, dt[0], gnorm, planes.mask.sum(), step0, planes)


def f64_clearances(cfg, consts, scene, spline) -> tuple[float, float]:
    """Min clearances of a fleet's splines [U, T, 3]: segment hull to cloud
    (the 32 nearest points by AABB distance of every segment, exact GJK) and
    hull to hull over every robot pair i < j at equal segment (exact GJK).
    Exact in float64 on the CPU, where GJK takes its plain version."""
    hulls = en.seg_cps(consts, spline)                               # [U,P,R,n,3]
    u, p, r, n, _ = hulls.shape
    cand = bp.topk_candidates(hulls, scene, radius=float("inf"), k=32)
    pts = scene.points[cand.idx]                                     # [U,P,R,32,3]
    diff = (hulls[:, :, :, None] - pts[..., None, :]).reshape(-1, n, 3)
    d = geo.batched_origin_dist(diff, 96).dist
    clr_obs = torch.where(cand.mask.reshape(-1), d, float("inf")).amin()
    diff = (hulls[:, None, :, :, :, None, :] - hulls[None, :, :, :, None, :, :])
    d = geo.batched_origin_dist(diff.reshape(-1, n * n, 3), 96).dist.reshape(u, u, p, r)
    iu = torch.triu_indices(u, u, offset=1)
    clr_pair = d[iu[0], iu[1]].amin()
    return float(clr_obs), float(clr_pair)


def fleet_energy(cfg, consts, state, planes, spline, piece_time) -> float:
    """The fleet's augmented-Lagrangian spline energy at (``spline``,
    ``piece_time``) with ``state``'s slacks and multipliers and ``planes``:
    the sum over robots, +inf where a robot's barrier is infeasible."""
    total = 0.0
    for i in range(spline.shape[0]):
        ev = en.spline_energy(consts, cfg, tt.index(state, i), tt.index(planes, i),
                              spline=spline[i], piece_time=piece_time[i])
        total += float("inf") if bool(ev.infeasible) else float(ev.value)
    return total


def _cpu64(obj):
    """A container (or tensor) on the CPU, floating fields in float64."""
    conv = lambda x: x.detach().to("cpu", torch.float64 if x.is_floating_point() else x.dtype)
    return conv(obj) if torch.is_tensor(obj) else type(obj)(*(conv(x) for x in obj))


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rel_entry(got, ref, tol):
    scale = max(abs(ref), 1e-12)
    return {"card": got, "cpu_f64": ref, "tol_rel": tol, "ok": bool(abs(got - ref) <= tol * scale)}


def kernels_required(cfg) -> tuple[str, ...]:
    """The kernels whose launch counts must move in the card's probe step."""
    return ("smallest_k", "gjk_exact", "factor_solve") + (
        ("eigvalsh",) if cfg.psd_method == "eigh" else ())


def probe(device, dtype=torch.float32, log=None, **cfg_options) -> dict:
    """The whole check: warm to congestion on ``device`` in ``dtype``, the
    direction there and one step from the warm state, then the float64
    oracle on the CPU.  Returns the report; ``report["failed"]`` names the
    entries that failed."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    log = log or (lambda s: None)
    t0 = time.perf_counter()
    cfg, consts, scene, state = build(device, dtype, **cfg_options)
    warm, warm_iter, history = warm_to_congestion(consts, cfg, state, scene)
    _sync(device)
    t_warm = time.perf_counter()
    log(f"warm iteration {warm_iter} (first with n_planes > 0 and ccd_step < 1; "
        f"(n_planes, ccd_step) per step {history})")

    _cuda.reset_launches()
    card = direction_and_planes(cfg, consts, scene, warm)
    _sync(device)
    direction_launches = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    post, _ = multi.multi_admm_step(consts, cfg, warm, scene, coupled=True)
    _sync(device)
    step_launches = dict(_cuda.LAUNCHES)
    t_card = time.perf_counter()

    # the float64 oracle on the CPU, from the card's warm state and inputs
    consts64, scene64, warm64 = _cpu64(consts), _cpu64(scene), _cpu64(warm)
    ref = direction_and_planes(cfg, consts64, scene64, warm64)
    clr_obs, clr_pair = f64_clearances(cfg, consts64, scene64, _cpu64(post.spline))
    e_warm = fleet_energy(cfg, consts64, warm64, ref.planes, warm64.spline, warm64.piece_time)
    e_post = fleet_energy(cfg, consts64, warm64, ref.planes, _cpu64(post.spline),
                          _cpu64(post.piece_time))
    oracle_launches = {k: c for k, c in _cuda.LAUNCHES.items() if c != step_launches[k]}
    t_oracle = time.perf_counter()

    ds_ref = ref.ds.numpy()
    dir_dev = float(abs(_cpu64(card.ds).numpy() - ds_ref).max()) / (float(abs(ds_ref).max()) or 1.0)
    n_card, n_ref = int(card.n_planes), int(ref.n_planes)
    required = kernels_required(cfg)
    if on_card:
        kernels_ok = all(step_launches[k] > 0 for k in required) and not oracle_launches
    else:
        kernels_ok = NOT_ON_A_CARD
    entries = {
        # planes -> analytic G/H -> PSD repair -> fused factor and solve ->
        # arrowhead Schur + iterative refinement
        "newton_direction": {"max_rel": dir_dev, "tol_rel": DIRECTION_TOL,
                             "ok": dir_dev <= DIRECTION_TOL},
        "time_direction": _rel_entry(float(card.dt), float(ref.dt), DIRECTION_TOL),
        "gnorm": _rel_entry(float(card.gnorm), float(ref.gnorm), DIRECTION_TOL),
        # a candidate within float32 eps of the query radius may flap: the
        # probe demands congestion, not equality
        "n_planes": {"card": n_card, "cpu_f64": n_ref,
                     "ok": n_card > 0 and n_ref > 0 and abs(n_card - n_ref) <= PLANE_SLACK},
        # the CCD's level-2/3 refinement ran on the card
        "ccd_refine_active": {"card_ccd_step": float(card.step0), "cpu_f64_ccd_step":
                              float(ref.step0), "ok": float(card.step0) < 1.0},
        "post_step_feasible": {
            "min_obstacle_clearance": clr_obs, "min_pair_clearance": clr_pair,
            "offset": cfg.offset,
            "ok": min(clr_obs, clr_pair) >= cfg.offset - CLEARANCE_SLACK,
        },
        "post_step_descent": {
            "e_warm_f64": e_warm, "e_post_f64": e_post,
            "ok": e_post < float("inf") and e_post <= e_warm + DESCENT_SLACK * abs(e_warm),
        },
        "kernels_active": {"required": list(required), "probe_step": step_launches,
                           "direction": direction_launches, "oracle": oracle_launches,
                           "ok": kernels_ok},
    }
    failed = [name for name, e in entries.items() if e["ok"] is False]
    return {
        "device": nvidia_smi_line() if on_card else f"cpu ({NOT_ON_A_CARD}: plain versions)",
        "device_kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "dtype": str(dtype).replace("torch.", ""),
        "psd_method": cfg.psd_method,
        "case": (f"{UAVS}-robot coupled cross, {N_POINTS} points, res {cfg.res}, probed at "
                 f"warm iteration {warm_iter} (first with n_planes > 0 and ccd_step < 1)"),
        "warm_iter": warm_iter,
        "warm_history": history,
        "deviations": entries,
        "seconds": {"warm": t_warm - t0, "card": t_card - t_warm, "oracle": t_oracle - t_card,
                    "total": t_oracle - t0},
        "failed": failed,
        "all_ok": not failed,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=" ".join(__doc__.split("\n\n")[0].split()))
    ap.add_argument("--psd-method", choices=PSD_METHODS, default="gmw")
    ap.add_argument("--out", metavar="FILE", help="write the report to FILE as JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="run the card's side on the CPU in float32 through the plain versions "
                         "(a rehearsal: kernels_active then reads 'not on a card')")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("tools/cuda_check.py runs on a CUDA device and none is available "
                           "(--cpu runs the rehearsal on the CPU)")
    report = probe(device, torch.float32, psd_method=args.psd_method)
    print(json.dumps({k: v["ok"] for k, v in report["deviations"].items()}))
    print(json.dumps(report, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
