#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`trajopt_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each reported on its own lines:
1. card and build: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the time to build the CUDA kernels from ``csrc/``;
2. every kernel (K1-K4) against its plain torch version on the card, in
   float32, at the shapes the single-UAV solve gives it plus edge cases;
3. the single-UAV bridge solve (the reference's benchmark scene) at P=4 and
   P=16 pieces on the card, checked against the C++ reference's trajectory
   quality (tools/ref_baseline/results.json) and, at P=4, against the
   port's own float64 CPU run; the kernels' launch counters must all move
   during each solve;
4. per-kernel times beside their plain versions at the P=4 shapes.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the exit code is non-zero and the last line is not printed.  Imports no
JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

SLICE_PIECES = (4, 16)
N_POINTS = 20000
MAX_ITERS = 2000
PARITY_TOL = 0.02          # tools/parity_report.py: ccd_time / ccd_len within 2%
ITER_SLACK = 2             # card f32 vs CPU f64 iteration counts (rung lattice)

KERNELS = {
    "smallest_k": ("trajopt_tpu_torch/csrc/topk.cu", "trajopt_tpu/ops/pallas_topk.py:53"),
    "gjk_exact": ("trajopt_tpu_torch/csrc/gjk.cu", "trajopt_tpu/ops/pallas_gjk.py:295"),
    "mod_chol": ("trajopt_tpu_torch/csrc/chol.cu", "trajopt_tpu/ops/pallas_chol.py:43"),
    "chol_solve": ("trajopt_tpu_torch/csrc/chol.cu", "trajopt_tpu/ops/pallas_chol.py:90"),
}


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernel against plain
# ---------------------------------------------------------------------------


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def topk_cases(device, rng):
    """(name, x, k) at the P=4 slice shapes plus ties and short rows."""
    import numpy as np
    import torch

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    def dists(rows, n, inf_frac):
        a = rng.random((rows, n)) ** 2 * 10.0
        a[rng.random((rows, n)) < inf_frac] = np.inf
        return a

    ties = np.round(rng.random((8, 1000)) * 20.0)
    short = np.full((4, 100), np.inf)
    short[:, rng.choice(100, 5, replace=False)] = rng.random(5)
    return [
        ("coarse [4,20000] k=64", t(dists(4, N_POINTS, 0.1)), 64),
        ("fine [32,64] k=16", t(dists(32, 64, 0.2)), 16),
        ("clearance [32,20000] k=8", t(dists(32, N_POINTS, 0.0)), 8),
        ("ccd segments [1,32] k=32", t(dists(1, 32, 0.5)), 32),
        ("ccd level1 [32,20000] k=17", t(dists(32, N_POINTS, 0.3)), 17),
        ("ccd level2 [32,16] k=9", t(dists(32, 16, 0.3)), 9),
        ("ties [8,1000] k=50", t(ties), 50),
        ("few finite [4,100] k=20", t(short), 20),
    ]


def check_topk(device, rng, log):
    import torch
    from trajopt_tpu_torch.ops import cuda_topk

    err = 0.0
    for name, x, k in topk_cases(device, rng):
        v, i = cuda_topk.smallest_k(x, k)
        _sync(device)
        pv, pi = cuda_topk.smallest_k_plain(x, k)
        check(torch.equal(v, pv), f"K1 {name}: values differ from the plain version")
        check(torch.equal(i, pi), f"K1 {name}: indices differ from the plain version")
        fin = torch.isfinite(pv)
        err = max(err, float((v[fin] - pv[fin]).abs().max()) if fin.any() else 0.0)
        log(f"  K1 smallest_k {name}: values and indices equal")
    return err


def brute_origin_dist(u):
    """Exact float64 distance from the origin to conv(u[i]) (u [N,m,3]):
    the minimum over every affinely independent vertex subset of size <= 3
    whose affine projection of the origin has non-negative barycentrics,
    and 0 when a 4-subset contains the origin."""
    import itertools

    import numpy as np

    u = np.asarray(u, dtype=np.float64)
    n, m, _ = u.shape
    best = np.full(n, np.inf)
    for k in (1, 2, 3):
        for sub in itertools.combinations(range(m), k):
            w = u[:, sub]                                        # [N,k,3]
            g = np.einsum("nid,njd->nij", w, w)
            a = np.zeros((n, k + 1, k + 1))
            a[:, :k, :k] = g
            a[:, :k, k] = 1.0
            a[:, k, :k] = 1.0
            rhs = np.zeros((n, k + 1))
            rhs[:, k] = 1.0
            sol = np.einsum("nij,nj->ni", np.linalg.pinv(a), rhs)
            lam = sol[:, :k]
            ok = (lam >= -1e-12).all(1) & (np.abs(lam.sum(1) - 1.0) < 1e-9)
            d = np.linalg.norm(np.einsum("ni,nid->nd", lam, w), axis=1)
            best = np.where(ok, np.minimum(best, d), best)
    for sub in itertools.combinations(range(m), 4):
        w = u[:, sub]
        a = np.concatenate([w.transpose(0, 2, 1), np.ones((n, 1, 4))], axis=1)
        rhs = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (n, 1))
        sol = np.einsum("nij,nj->ni", np.linalg.pinv(a), rhs)
        res = np.abs(np.einsum("nij,nj->ni", a, sol) - rhs).max(1)
        inside = (sol >= -1e-12).all(1) & (res < 1e-9)
        best = np.where(inside, 0.0, best)
    return best


def gjk_cases(device, rng):
    import numpy as np
    import torch

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    hulls = rng.normal(size=(512, 6, 3)) * 0.3
    pts = rng.normal(size=(512, 1, 3)) * 1.5
    a, b = rng.normal(size=(128, 1, 3)), rng.normal(size=(128, 1, 3))
    s = np.sort(rng.random((128, 6, 1)), axis=1)
    collinear = a * (1 - s) + b * s - rng.normal(size=(128, 1, 3)) * 0.8
    coplanar = rng.normal(size=(128, 6, 3))
    coplanar[..., 2] = 0.4 * rng.choice([-1.0, 1.0], size=(128, 1))
    base = rng.normal(size=(128, 3, 3))
    coincident = np.repeat(base, 2, axis=1) + rng.normal(size=(128, 1, 3))
    far = rng.normal(size=(256, 6, 3)) * 0.2 + np.array([3.0, -1.0, 0.5])
    return [
        ("plane fit [512,6,3] iters=16", t(hulls - pts), 16),
        ("ccd level3 [256,6,3] iters=16", t(far), 16),
        ("clearance [256,6,3] iters=32", t(far[:, ::-1]), 32),
        ("collinear [128,6,3]", t(collinear), 16),
        ("coplanar [128,6,3]", t(coplanar), 16),
        ("coincident [128,6,3]", t(coincident), 16),
    ]


def check_gjk(device, rng, log):
    import torch
    from trajopt_tpu_torch.ops import cuda_gjk

    err = 0.0
    for name, u, iters in gjk_cases(device, rng):
        hd = cuda_gjk.gjk_exact(u, iters)
        _sync(device)
        ref = cuda_gjk.gjk_exact_plain(u, iters)
        scale = u.abs().amax(dim=(1, 2))
        true = torch.as_tensor(brute_origin_dist(u.double().cpu().numpy()), device=device)
        # where the origin touches or lies in the hull, lb is a path-dependent
        # non-positive number (no separation certificate): only its soundness
        # is compared there
        sep = true > 1e-3 * scale.double()
        e_dist = (hd.dist - ref.dist).abs() / scale
        e_lb = torch.where(sep, (hd.lb - ref.lb).abs() / scale, 0.0)
        check(bool((e_dist <= 1e-5).all()),
              f"K2 {name}: dist differs from plain by {float(e_dist.max()):.3g} x scale")
        check(bool((e_lb <= 1e-5).all()),
              f"K2 {name}: lb differs from plain by {float(e_lb.max()):.3g} x scale")
        over = ((hd.lb.double() - true) / scale.double()).max()
        check(float(over) <= 1e-6, f"K2 {name}: lb exceeds the true distance by {float(over):.3g} x scale")
        err = max(err, float((hd.dist - ref.dist).abs().max()),
                  float(torch.where(sep, (hd.lb - ref.lb).abs(), 0.0).max()))
        log(f"  K2 gjk_exact {name}: |dist-plain|/scale {float(e_dist.max()):.2e}, "
            f"|lb-plain|/scale {float(e_lb.max()):.2e} ({int(sep.sum())} separated of {len(sep)}), "
            f"max (lb-true)/scale {float(over):.2e}")
    return err


def chol_cases(device, rng):
    import numpy as np
    import torch

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    def spd(b, m, cond):
        q, _ = np.linalg.qr(rng.normal(size=(b, m, m)))
        ev = np.logspace(0, np.log10(cond), m)
        return np.einsum("bij,j,bkj->bik", q, ev, q)

    sym = rng.normal(size=(4, 19, 19))
    indefinite = sym + sym.transpose(0, 2, 1)
    return [
        ("PD [4,19,19] cond 1e2", t(spd(4, 19, 1e2)), True),
        ("indefinite [4,19,19]", t(indefinite), False),
        ("KKT-like [1,33,33] cond 1e2", t(spd(1, 33, 1e2)), True),
        ("KKT-like [1,33,33] cond 1e6", t(spd(1, 33, 1e6)), True),
    ]


def check_chol(device, rng, log):
    import torch
    from trajopt_tpu_torch.ops import cuda_chol

    err = 0.0
    factors = []
    for name, h, pd in chol_cases(device, rng):
        l, e = cuda_chol.mod_chol(h)
        _sync(device)
        pl, pe = cuda_chol.mod_chol_plain(h)
        if pd:
            check(bool((e == 0).all()) and bool((pe == 0).all()),
                  f"K3 {name}: GMW boosted a positive-definite block")
        hd = h.double()
        rec = l.double() @ l.double().transpose(-1, -2)
        target = hd + torch.diag_embed(e.double())
        rel = float(torch.linalg.matrix_norm(rec - target).max() / torch.linalg.matrix_norm(hd).max())
        check(rel <= 1e-5, f"K3 {name}: |L L^T - (h + diag e)| / |h| = {rel:.3g}")
        el = float((l - pl).abs().max() / pl.abs().max())
        ee = float((e - pe).abs().max() / max(float(pe.abs().max()), 1e-30)) if bool((pe != 0).any()) else float(e.abs().max())
        check(el <= 1e-4, f"K3 {name}: L differs from plain by {el:.3g} relative")
        check(ee <= 1e-4, f"K3 {name}: e differs from plain by {ee:.3g} relative")
        if pd:
            lp, ep = cuda_chol.mod_chol(h, gmw=False)
            _sync(device)
            check(bool((ep == 0).all()) and bool(torch.isfinite(lp).all()),
                  f"K3 {name}: plain Cholesky mode failed on a PD block")
            dp = float((lp - l).abs().max() / l.abs().max())
            check(dp <= 1e-5, f"K3 {name}: gmw=False differs on a PD block by {dp:.3g}")
        err = max(err, float((l - pl).abs().max()), float((e - pe).abs().max()))
        factors.append((name, l))
        log(f"  K3 mod_chol {name}: recon {rel:.2e}, L vs plain {el:.2e}, e vs plain {ee:.2e}")
    return err, factors


def _residual(l, x, b):
    """|L L^T x - b| / |b| in float64."""
    xm = x if x.ndim == 3 else x[..., None]
    bm = b if b.ndim == 3 else b[..., None]
    return float((l @ (l.transpose(-1, -2) @ xm) - bm).norm() / bm.norm())


def check_solve(device, rng, factors, log):
    import numpy as np
    import torch
    from trajopt_tpu_torch.ops import cuda_chol

    err = 0.0
    for name, l in factors:
        b, m = l.shape[0], l.shape[-1]
        rhs_shapes = [(b, m), (b, m, 2)] if m == 33 else [(b, m)]
        for shape in rhs_shapes:
            rhs = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=device)
            x = cuda_chol.chol_solve(l, rhs)
            _sync(device)
            px = cuda_chol.chol_solve_plain(l, rhs)
            ld, xd = l.double(), x.double()
            res = _residual(ld, xd, rhs.double())
            res_plain = _residual(ld, px.double(), rhs.double())
            dx = float((x - px).abs().max() / px.abs().max())
            # a float32 solve reaches 1e-5 only on well-conditioned factors;
            # elsewhere the plain version's residual is the floor
            bound = 1e-5 if "cond 1e2" in name else max(1e-5, 2.0 * res_plain)
            check(res <= bound, f"K4 {name} rhs {shape}: residual {res:.3g} (plain {res_plain:.3g})")
            check(dx <= 1e-3, f"K4 {name} rhs {shape}: x differs from plain by {dx:.3g} relative")
            err = max(err, float((x - px).abs().max()))
            log(f"  K4 chol_solve L {name} rhs {list(shape)}: residual {res:.2e} "
                f"(plain {res_plain:.2e}), x vs plain {dx:.2e}")
    return err


def check_kernels(device, log, seed=0):
    """Every kernel against its plain version; returns max abs errors."""
    import numpy as np

    rng = np.random.default_rng(seed)
    errs = {"smallest_k": check_topk(device, rng, log), "gjk_exact": check_gjk(device, rng, log)}
    errs["mod_chol"], factors = check_chol(device, rng, log)
    errs["chol_solve"] = check_solve(device, rng, factors, log)
    return errs


# ---------------------------------------------------------------------------
# Phase 3: the solve
# ---------------------------------------------------------------------------


def build_problem(pieces, device, dtype):
    from trajopt_tpu.config import TrajOptConfig
    from trajopt_tpu.ops import splines as sp
    from trajopt_tpu.scenes import generators as gen
    from trajopt_tpu_torch import types as tt

    cfg = TrajOptConfig(ks=1e-8, max_planes=16, max_ccd_candidates=16)
    cloud, wp = gen.bridge_scene(n_points=N_POINTS, seed=0, n_pieces=pieces)
    ops = sp.build_spline_ops(pieces, cfg.res)
    kw = dict(device=device, dtype=dtype)
    return (cfg, ops, cloud, tt.device_consts(ops, **kw), tt.make_scene(cloud, **kw),
            tt.init_state(ops, wp, cfg.init_piece_time, **kw))


def solve_case(pieces, device, dtype):
    """One bridge solve; returns the result row (iterations, quality, timing)."""
    from trajopt_tpu import metrics as mt
    from trajopt_tpu_torch.solver import driver

    cfg, ops, cloud, consts, scene, state0 = build_problem(pieces, device, dtype)
    t0 = time.perf_counter()
    state, hist = driver.solve(consts, cfg, state0, scene, max_iters=MAX_ITERS)
    wall = time.perf_counter() - t0
    spline = state.spline.detach().double().cpu().numpy()
    piece_time = float(state.piece_time)
    st = mt.trajectory_stats(ops, spline, piece_time)
    return {
        "pieces": pieces,
        "iters": len(hist),
        "gnorm": hist[-1]["gnorm"],
        "converged": len(hist) < MAX_ITERS and hist[-1]["gnorm"] < cfg.stop,
        "ccd_time": st["ccd_time"],
        "ccd_len": st["ccd_len"],
        "min_clearance": mt.min_curve_clearance(ops, spline, cloud, piece_time),
        "offset": cfg.offset,
        "median_iter_ms": statistics.median(h["wall_ms"] for h in hist),
        "solve_s": wall,
    }


def reference_row(pieces):
    with open(os.path.join(HERE, "tools", "ref_baseline", "results.json")) as f:
        for case in json.load(f)["cases"]:
            if case["mode"] == "single" and case["pieces"] == pieces:
                return case
    raise KeyError(f"no C++ reference row for single p{pieces}")


def check_parity(row, log):
    ref = reference_row(row["pieces"])
    dtime = abs(row["ccd_time"] - ref["ccd_time"]) / ref["ccd_time"]
    dlen = abs(row["ccd_len"] - ref["ccd_len"]) / ref["ccd_len"]
    log(f"  vs C++ p{row['pieces']}: iters {ref['iters']} / {row['iters']}, "
        f"ccd_time {ref['ccd_time']:.4f} / {row['ccd_time']:.4f} ({dtime * 100:.2f}%), "
        f"ccd_len {ref['ccd_len']:.4f} / {row['ccd_len']:.4f} ({dlen * 100:.2f}%), "
        f"min clearance {row['min_clearance']:.4f} (offset {row['offset']})")
    check(row["converged"], f"p{row['pieces']}: did not converge")
    check(dtime <= PARITY_TOL, f"p{row['pieces']}: ccd_time off by {dtime * 100:.2f}%")
    check(dlen <= PARITY_TOL, f"p{row['pieces']}: ccd_len off by {dlen * 100:.2f}%")
    check(row["min_clearance"] >= row["offset"], f"p{row['pieces']}: clearance below offset")


def count_syncs(pieces, device):
    """Host syncs in one steady ADMM iteration, by source line."""
    import collections
    import traceback

    import torch
    from trajopt_tpu_torch.solver import admm

    cfg, ops, cloud, consts, scene, state = build_problem(pieces, device, torch.float32)
    state, _ = admm.admm_step(consts, cfg, state, scene)
    torch.cuda.synchronize()
    where = collections.Counter()
    pkg = os.path.join(HERE, "trajopt_tpu_torch")

    def record(message, *args, **kwargs):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack() if f.filename.startswith(pkg)]
            if frames:          # switching the debug mode on warns once itself
                f = frames[-1]
                where[f"{os.path.relpath(f.filename, HERE)}:{f.lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            admm.admm_step(consts, cfg, state, scene)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return where


# ---------------------------------------------------------------------------
# Phase 4: timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps=50):
    """Mean ms per call between CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_timings(device):
    """(kernel ms, plain ms) at the P=4 slice shapes, alternating kernel and
    plain runs (kernel, plain, plain, kernel) and keeping each one's best."""
    import numpy as np
    import torch
    from trajopt_tpu_torch.ops import cuda_chol, cuda_gjk, cuda_topk

    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.as_tensor(rng.random((32, N_POINTS)), **f32)
    u = torch.as_tensor(rng.normal(size=(512, 6, 3)), **f32)
    a = rng.normal(size=(4, 19, 19))
    h = torch.as_tensor(a @ a.transpose(0, 2, 1) + 19 * np.eye(19), **f32)
    k = rng.normal(size=(1, 33, 33))
    kkt = torch.as_tensor(k @ k.transpose(0, 2, 1) + 33 * np.eye(33), **f32)
    l33 = cuda_chol.mod_chol(kkt)[0]
    rhs = torch.as_tensor(rng.normal(size=(1, 33, 2)), **f32)
    cases = {
        "smallest_k": ("[32,20000] k=17", lambda: cuda_topk.smallest_k(x, 17),
                       lambda: cuda_topk.smallest_k_plain(x, 17)),
        "gjk_exact": ("[512,6,3] iters=16", lambda: cuda_gjk.gjk_exact(u, 16),
                      lambda: cuda_gjk.gjk_exact_plain(u, 16)),
        "mod_chol": ("[4,19,19]", lambda: cuda_chol.mod_chol(h),
                     lambda: cuda_chol.mod_chol_plain(h)),
        "chol_solve": ("L [1,33,33], b [1,33,2]", lambda: cuda_chol.chol_solve(l33, rhs),
                       lambda: cuda_chol.chol_solve_plain(l33, rhs)),
    }
    out = {}
    for name, (shape, kern, plain) in cases.items():
        reps_plain = 5 if name == "gjk_exact" else 50
        k1 = time_ms(kern)
        p1 = time_ms(plain, reps_plain)
        p2 = time_ms(plain, reps_plain)
        k2 = time_ms(kern)
        out[name] = (shape, min(k1, k2), min(p1, p2))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "trajopt_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from trajopt_tpu_torch.ops import _cuda

    log = lambda s: print(s, flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 ------------------------------------------------------------
    log("== phase 1: card and build")
    log(nvidia_smi_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {_cuda.build_info['seconds']:.2f} s, "
        f"cached={_cuda.build_info['cached']})")
    for line in _cuda.build_info["log"].splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    # -- phase 2 ------------------------------------------------------------
    log("== phase 2: kernels against their plain versions (float32, on the card)")
    errs = check_kernels(device, log)

    # -- phase 3 ------------------------------------------------------------
    log("== phase 3: single-UAV bridge solves (float32, on the card)")
    launches = {}
    rows = {}
    for pieces in SLICE_PIECES:
        _cuda.reset_launches()
        row = solve_case(pieces, device, torch.float32)
        torch.cuda.synchronize()
        launches[pieces] = dict(_cuda.LAUNCHES)
        rows[pieces] = row
        log(f"  p{pieces}: iters {row['iters']}, gnorm {row['gnorm']:.4g}, "
            f"ccd_time {row['ccd_time']:.4f}, ccd_len {row['ccd_len']:.4f}, "
            f"min clearance {row['min_clearance']:.4f}, median {row['median_iter_ms']:.2f} ms/iter, "
            f"solve {row['solve_s']:.2f} s, launches {launches[pieces]}")
        for name, n in launches[pieces].items():
            check(n > 0, f"p{pieces}: kernel {name} was never launched by the solve")
        check_parity(row, log)
    cpu = solve_case(SLICE_PIECES[0], torch.device("cpu"), torch.float64)
    log(f"  p{SLICE_PIECES[0]} CPU float64: iters {cpu['iters']}, gnorm {cpu['gnorm']:.4g}, "
        f"ccd_time {cpu['ccd_time']:.4f}, ccd_len {cpu['ccd_len']:.4f}")
    gap = abs(cpu["iters"] - rows[SLICE_PIECES[0]]["iters"])
    check(gap <= ITER_SLACK, f"card and CPU float64 iteration counts differ by {gap}")
    syncs = count_syncs(SLICE_PIECES[0], device)
    log(f"  host syncs in one p{SLICE_PIECES[0]} iteration: {sum(syncs.values())}")
    for where, n in sorted(syncs.items()):
        log(f"    {n:3d}  {where}")

    # -- phase 4 ------------------------------------------------------------
    log("== phase 4: kernel vs plain times at the P=4 shapes (CUDA events)")
    times = kernel_timings(device)
    for name, (shape, ms, plain_ms) in times.items():
        log(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[SLICE_PIECES[0]][name], "max_abs_err": errs[name],
            "ms": times[name][1], "plain_ms": times[name][2],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
