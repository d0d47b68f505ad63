#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`trajopt_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each reported on its own lines with the seconds it took:
1. card and build: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, the time to build the CUDA kernels from ``csrc/``, and
   the CUDA runtime and driver versions that decide the form of an IF/ELSE
   node (one node with an ELSE body from 12.8, else two IF nodes);
2. first the conditional graph nodes and their ``set_condition`` kernel
   against the host branch (`cond_probe`: two IF nodes, an IF/ELSE, a
   WHILE to its bound, one stopped by its predicate and one of 0 trips, a
   WHILE in a WHILE with an IF in it; each capture launched at several
   inputs, bit-equal, its ``set_condition`` executions equal to the
   conditions the nodes' CPU stand-in reads); then
   every kernel (K1-K5 and the fused K3 + K4 launch) against its plain
   torch version in float32, at the shapes the single-UAV and the 64-robot
   solves give it plus edge cases (for K1, K2 and K5 aimed at each route:
   ties, signed zeros, NaN and +inf, k = 1 and k = n, m = 1 to 80 for K2
   and 1 to 513 for K5 (its three tiers, 12-vertex hull pairs at m = 144),
   duplicate vertices, the origin inside, coplanar sets, pairs at 1e3
   scale; for K3, K4 and the fused kernel: m = 1 to 64 on each side of
   the tiers, zero, diagonal, negative definite and scaled blocks, batches
   of 1 and 4097, ``gmw=False`` on non-PD blocks, four right-hand-side
   layouts); the ``optimal_plane`` path's own inputs taken from the start
   states (K2 on the full plane tables [512,6,3] and [32768,6,3], far slots
   included; K1 at the per-robot broad phase's [64,4,4000] and
   [64,4,8,64]), and the fused kernel with ``gmw=False`` (the ``eigh``
   slack step) at [4,19,19] and [256,19,19]; then every call that phase
   8's paths make, one call of each shape from a select-form step of each
   of its problems with each method (and of the 1024 batch): K6 against
   float64 eigenvalues (within 1e-5 x |H|_F), also on edge blocks (m = 1
   to 32, diagonal, definite, repeated eigenvalues, scales 1e-6 and 1e6,
   NaN and inf, batches of 1 and 4097), K3's plain mode on every trial of
   the shift ladder (its rungs and bisection steps; the PD verdicts
   against the float64 spectrum), and K3, K4 and the fused kernel on the
   rest as on phase 7's; and `slack_step`, the slack phase in one launch,
   on `testing.SLACK_CASES` (1 to 1024 robots of 1 to 20 pieces, a NaN
   dual, a float32 overflow, the step clamp) against its plain version on
   the card and in float64 on the CPU (`check_slack_case`);
3. the single-UAV bridge solve (the reference's benchmark scene) at P=4 and
   P=16 pieces on the card, checked against the C++ reference's trajectory
   quality (tools/ref_baseline/results.json) and, at P=4, against the
   port's own float64 CPU run; the kernels' launch counters must all move
   during each solve; then at P=4 with ``optimal_plane`` (against the
   port's CPU float64 run and the JAX package's CPU float64 row, host
   syncs <= 4), with ``psd_method="eigh"`` (against the C++ row), and a
   checkpoint-and-resume of the default and the ``optimal_plane`` solve
   that must end at the uninterrupted run's iteration count;
4. the 64-robot cross (the repository's north-star configuration) in
   coupled and decoupled mode on the card: convergence, trajectory quality
   against the C++ rows, obstacle clearance, pairwise clearance by K2
   cross-checked by K5, launches of K1-K4 and the fused kernel in each
   solve, also by call shape, host syncs per steady iteration and the
   device's idle
   share; then 4 robots coupled on the card against the port's float64 CPU
   run and the C++ row; then the cross coupled with ``optimal_plane``
   (32768 K2 slots an iteration) against the JAX package's CPU float64
   row, with the same clearance, launch, sync (<= 9) and idle checks, and
   4 robots coupled with ``optimal_plane`` against the port's CPU float64
   run;
5. per-kernel times beside their plain versions, the least time the card
   could take for the same work, and the one PyTorch call that computes the
   same function where there is one; then K1 (beside `torch.topk`), K2 and
   K5 (with its route) at every shape of phase 2, K5 at the cross-check's
   shape with 1, 2, 4 and 8 lanes a problem and at m = 6 to 64 and 16 to
   64512 problems with each routed G (`fw_route_matrix`), and K3, K4 and
   the fused kernel at every call-site shape beside their latency floor
   (an empty kernel plus m or 2m dependent steps, measured by a one-warp
   probe); what the P = 16 KKT (ns = 141) pays per call; last K6 at the
   solver's call shapes beside float32 `torch.linalg.eigvalsh` (busy ms:
   it cannot be captured) and its latency floor (an empty kernel plus the
   rounds of the slowest block, counted by `testing.eig_kernel_model`,
   times one round of its probe), one launch alone and busy inside the
   graph beside the graph's device ms, and K3's plain mode at the ladder's
   trial shapes beside `torch.linalg.cholesky_ex`; the fused kernel with
   ``gmw=False`` beside `torch.linalg.solve`; `slack_step` at [4|256|
   4096,19,19] beside its plain version (`slack_timings`); last ``set_condition``
   (`set_condition_timings`: a chain of 50 ``device_cond`` nodes in one
   graph, ms a node beside the select form's link, the kernel's own time
   from profiler records, and its plain version, a host read).  ``ms`` is
   per call between CUDA events (the host's cost of issuing a call
   included), ``device_ms`` from 50 launches in one CUDA graph;
6. the fused drivers (`solve_fused` on the bridge at P=4 and P=16,
   `solve_fused_multi` on the 64-robot cross coupled and decoupled,
   `solve_fused_multi_cached` on the cross coupled with ``optimal_plane``),
   each solve one CUDA graph launched once (the conditional form: the
   loop a WHILE node, each branch an IF node), then the same loop in the
   select form (one step's graph replayed, a flag read each): the
   host-stepped solve's iteration count of phases 3-4 and a final state
   bit-equal to it in both forms, the C++ gate (the JAX row with
   ``optimal_plane``), pairwise clearance by K2, host syncs = 2 final
   reads (select: + the replays), the IF and WHILE nodes, kernel nodes per
   capture and their executions in the solve (from the nodes' tallies)
   beside the host-stepped solve's launches, warm-up and capture ms,
   replay and whole-call ms per iteration of each form beside the
   host-stepped solve's, and device busy and idle share over one whole
   solve of each form, captured again and launched after
   `torch.cuda.empty_cache` (bit-equal: the graph owns what it reads);
   the graph cache (`runtime/cache.py`): after each conditional call two
   more, from the start moved by 1e-7 (bench.py's perturbation) and from
   the first start, each a hit (1 launch, 2 host syncs, warm-up, capture
   and instantiation 0), the last bit-equal to the first call and to the
   host-stepped solve, the first call's result untouched; whole-call ms
   per iteration of the miss and the hits, each entry's pool bytes and
   the peak memory of the miss; the hits again after
   `torch.cuda.empty_cache`;
7. scenario batches and sharding: `solve_fused_batch` at bench_scale.py's
   batches of 16 and 1024 jittered bridge scenarios (2000 points, P=4, 50
   iterations), three of the 16 against their own `solve_fused`, every
   scenario's clearance; the convergence gate (16 scenarios of phase 3's
   problem, default stop on the mean gnorm, scenario 0 against the C++
   row); `solve_fused_batch_multi` at bench_scale.py's 4 and 16 fleets of
   the 4-robot cross (coupled, and decoupled at 4), fleets 0 and B-1
   against their own `solve_fused_multi`, every fleet's pair clearance by
   K2 cross-checked by K5; each with warm-up and capture ms, launch ms per
   iteration, scenario-iterations per second, kernel nodes per capture and
   their executions, and the solve captured again and launched after
   `torch.cuda.empty_cache`, bit-equal (no profiler: `log_batch_run`); a
   cache hit of the 16 with new jitter, bit-equal to a fresh capture;
   then sharding on a single-rank NCCL
   group: the 64-robot cross's sharded step (3 steps, both modes) and
   `solve_fused_multi(axis_name=...)` bit-equal to the unsharded ones,
   and its cache hit from a moved start bit-equal to a fresh capture,
   the 2-D mesh step, the scenario-sharded solver, and
   ``torchrun --nproc-per-node 1 ... cli.multi --mesh-devices 1`` against
   the unsharded CLI;
8. every PSD repair on every driver: ``psd_method="eigh"`` and
   ``"ladder"`` on the bridge at P=4 and the 64-robot cross coupled,
   host-stepped and fused, the fused solves as phase 6's (the fused solve
   takes the host-stepped count with a bit-equal state; ``eigh`` held to
   the C++ gate, ``"ladder"`` to the JAX package's CPU float64 row,
   `testing.PSD_JAX_ROWS`, the C++ offsets printed beside it; K6 launched
   in every ``eigh`` solve and K3 not, K3 in every ladder solve and K6
   not; host syncs = 2 (select: + the replays), and of one host-stepped
   iteration from the converged state; replay ms, warm-up and capture,
   kernel nodes and executions, the relaunch after `torch.cuda.empty_cache`);
   `solve_fused_batch` at B = 16 with each method (scenarios against
   their own `solve_fused`), and the cross's ladder solve sharded at
   world size 1, bit-equal to the unsharded one;
9. one congested step against float64 (`tools/cuda_check.py`, with
   ``psd_method`` "gmw" and "eigh"): the 8-robot coupled cross of 2000
   points warmed on the card to its first step with live planes and a
   coupled CCD limit below 1, then the card's float32 Newton direction, dt
   and gnorm within 5e-3 of the CPU float64 oracle's on the same warm
   state, live plane counts within 2, the card's CCD limit below 1, the
   card's post step certified in float64 (obstacle and pair clearance >=
   offset - 1e-5, a descent of the augmented-Lagrangian energy), and K1,
   K2 and the fused K3 + K4 launch (and K6 under "eigh") launched in the
   probe step, none in the oracle.

Each phase that runs fused drivers ends with `cache.clear()`, so that no
phase holds the graph cache's pools of another.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the exit code is non-zero and the last line is not printed.  Imports no
JAX and nothing of the JAX package.

    python3 chip_smoke.py --time-shapes DIR [--out FILE]

runs only phase 5's K1/K2/K5, K3/K4 and K6 shape timings of the checkout
DIR's port on this checkout's inputs (a K5 that takes m <= 64 only reads
"refused" at the larger shapes), with a digest of each Cholesky and
eigenvalue output (to compare two commits on one card, in time and bit for
bit: parent, change, change, parent in one call).

    python3 chip_smoke.py --time-calls DIR [--out FILE]

times four whole calls of each of phase 6's five fused drivers by the
checkout DIR's port (from the start, the moved start, the start again, and
once more after `cache.clear()`; `time_fused_calls`), to compare the graph
cache's hits and misses with a port that captures at every call.
"""

from __future__ import annotations

import collections
import functools
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

FLEET = 64                 # robots of the north-star cross (bench.py, __graft_entry__.py)
FLEET_PIECES = 4
FLEET_POINTS = 4000
FLEET_MAX_ITERS = 600      # tools/parity_report.py's cap
SMALL_FLEET = 4            # card vs CPU float64 comparison

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores

KERNELS = {
    "smallest_k": ("trajopt_tpu_torch/csrc/topk.cu", "trajopt_tpu/ops/pallas_topk.py:53"),
    "gjk_exact": ("trajopt_tpu_torch/csrc/gjk.cu", "trajopt_tpu/ops/pallas_gjk.py:295"),
    "gjk_fw": ("trajopt_tpu_torch/csrc/gjk_fw.cu", "trajopt_tpu/ops/pallas_gjk.py:35"),
    "mod_chol": ("trajopt_tpu_torch/csrc/chol.cu", "trajopt_tpu/ops/pallas_chol.py:43"),
    "chol_solve": ("trajopt_tpu_torch/csrc/chol.cu", "trajopt_tpu/ops/pallas_chol.py:90"),
    "factor_solve": ("trajopt_tpu_torch/csrc/chol.cu",
                     "trajopt_tpu/ops/pallas_chol.py:43 and :90 (one launch for both)"),
    "eigvalsh": ("trajopt_tpu_torch/csrc/eig.cu",
                 "trajopt_tpu/ops/gradients.py:414 (XLA's eigvalsh; no Pallas site)"),
    "set_condition": ("trajopt_tpu_torch/csrc/graph_cond.cu",
                      "trajopt_tpu/solver/driver.py:318 (XLA's lowering of lax.while_loop and "
                      "lax.cond; no Pallas site)"),
    "slack_step": ("trajopt_tpu_torch/csrc/slack.cu",
                   "trajopt_tpu/solver/admm.py:501 (slack_update, left to XLA; no Pallas site)"),
}
# the kernels every solve must launch (K5 runs in the clearance cross-check)
SOLVE_KERNELS = ("smallest_k", "gjk_exact", "mod_chol", "chol_solve", "factor_solve")
# and every fused solve in the conditional form: its nodes' conditions
FUSED_KERNELS = SOLVE_KERNELS + ("set_condition",)
# the phase-2 case whose shape_timings row stands for K1 and K2 in the
# kernels line (64-robot coupled shapes)
HEADLINE = {"smallest_k": "fleet coarse [32,4000] k=64",
            "gjk_exact": "self planes [1024,36,3] iters=16"}
# the `psd_timings` shape that stands for K6 in the kernels line (the
# 64-robot cross's slack blocks)
EIG_HEADLINE = f"[{FLEET * FLEET_PIECES},19,19]"


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


def ptxas_report(text: str) -> list[str]:
    """One line per kernel from nvcc's ``-Xptxas=-v`` output: its name
    (demangled by ``c++filt`` where the machine has it) with its registers,
    barriers, shared memory, stack frame and spills."""
    import re
    import shutil

    entries, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            entries[name] = []
        elif name and ("Used" in line or "spill" in line):
            entries[name].append(line.split(":", 1)[-1].strip())
    names = list(entries)
    shown = names
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            shown = [s.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                     for s in out.stdout.splitlines()]
    return [f"{s}: {'; '.join(entries[n])}" for s, n in zip(shown, names)]


# ---------------------------------------------------------------------------
# Phase 2: kernel against plain
# ---------------------------------------------------------------------------


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _f32(device):
    import numpy as np
    import torch

    return lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)


def recorded_calls(module, name, run):
    """The positional arguments of every call of ``module.name`` that
    ``run()`` makes (the wrappers are looked up on their module at each
    call, so a stand-in there sees them all)."""
    real, calls = getattr(module, name), []

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, real)
    return calls


@functools.lru_cache(maxsize=None)
def optimal_plane_inputs(device):
    """The K1 and K2 inputs of the ``optimal_plane`` obstacle planes at the
    start states of the bridge (P=4) and the 64-robot cross: the full plane
    tables that K2 gets there, every (segment, candidate) slot with the far
    ones included ([512,6,3] and [32768,6,3]), and the cross's per-robot
    two-level broad phase (K1 at [64,4,4000] k=64 and [64,4,8,64] k=16,
    where the default path compacts the fleet).  Returns (K1 cases, K2
    cases) as `topk_cases` and `gjk_cases` list them; made once a run."""
    import torch
    from trajopt_tpu_torch.ops import cuda_gjk, cuda_topk
    from trajopt_tpu_torch.solver import admm

    topk, gjk = [], []
    for label, build in (("bridge P=4", lambda: build_problem(SLICE_PIECES[0], device, torch.float32)),
                         (f"u{FLEET} cross", lambda: build_fleet(FLEET, device, torch.float32))):
        cfg, _, _, consts, scene, state = build()
        cfg = cfg.replace(optimal_plane=True)
        run = lambda: admm.separate_planes(consts, cfg, state.spline, scene)
        for u, iters in recorded_calls(cuda_gjk, "gjk_exact", run):
            gjk.append((f"full table {label} {list(u.shape)} iters={iters}", u, iters, 256))
        if label != "bridge P=4":       # the bridge's K1 shapes are the default path's
            for x, k in recorded_calls(cuda_topk, "smallest_k", run):
                topk.append((f"optimal {label} {list(x.shape)} k={k}", x.contiguous(), k))
    return topk, gjk


BATCH_KERNELS = (("cuda_topk", "smallest_k"), ("cuda_gjk", "gjk_exact"), ("cuda_chol", "mod_chol"),
                 ("cuda_chol", "chol_solve"), ("cuda_chol", "factor_solve"))


def _dims(args) -> str:
    return " ".join(f"[{','.join(map(str, a.shape))}]" if hasattr(a, "shape") else str(a)
                    for a in args)


def step_call_inputs(problems, kernels, phase):
    """The inputs that one step in the select form (both sides of every
    branch, as the CUDA graph holds them) of each of ``problems`` [(label,
    step, carry)] hands ``kernels`` [(module, name)], one call of each
    distinct shape and keywords.  Returns {kernel: [(label, args, kwargs)]},
    the tensors cloned."""
    import importlib

    import torch
    from trajopt_tpu_torch.runtime import graph

    mods = {m: importlib.import_module(f"trajopt_tpu_torch.ops.{m}") for m, _ in kernels}
    out, seen, real = {name: [] for _, name in kernels}, set(), {}

    def spy(name, label):
        def call(*args, **kwargs):
            key = (name, _dims(args), tuple(sorted(kwargs.items())))
            if key not in seen:
                seen.add(key)
                kw = "".join(f" {k}={v}" for k, v in sorted(kwargs.items()))
                out[name].append((f"{phase} {label} {_dims(args)}{kw}",
                                  tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                                  dict(kwargs)))
            return real[name](*args, **kwargs)
        return call

    for label, step, carry in problems:
        for m, name in kernels:
            real[name] = getattr(mods[m], name)
            setattr(mods[m], name, spy(name, label))
        try:
            with graph.select_form():
                step(carry)
        finally:
            for m, name in kernels:
                setattr(mods[m], name, real[name])
    return out


@functools.lru_cache(maxsize=None)
def batch_call_inputs(device):
    """The inputs that phase 7's batch paths hand K1-K4 and the fused
    launch (`step_call_inputs`) from the start of each problem of phase 7
    (a) (B = 16 and 1024), (b) (the gate batch) and (c) (fleets coupled at
    B = 4 and 16, decoupled at B = 4); made once a run."""
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.solver import driver

    problems = []
    for b in BATCH_SIZES:
        cfg, _, _, consts, scene, states = build_batch(b, device)
        problems.append((f"batch{b} single", driver.fused_step(consts, cfg, scene, False,
                                                               interact=False), (states,)))
    cfg, _, _, consts, scene, states = build_batch(GATE_BATCH, device, n_points=N_POINTS, stop=None,
                                                   unjittered_first=True)
    problems.append((f"batch{GATE_BATCH} gate", driver.fused_step(consts, cfg, scene, False,
                                                                  interact=False), (states,)))
    for b, coupled in [(b, True) for b in FLEET_BATCHES] + [(FLEET_BATCHES[0], False)]:
        cfg, _, _, consts, scene, states = build_fleet_batch(b, device)
        flat = tt.SolverState(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in states))
        problems.append((f"batch{b} u{BATCH_FLEET} {'coupled' if coupled else 'decoupled'}",
                         driver.fused_step(consts, cfg, scene, coupled, groups=b), (flat,)))
    out = step_call_inputs(problems, BATCH_KERNELS, "phase 7")
    _sync(device)
    return out


def batch_chol_timing_inputs(device):
    """`chol_callsite_inputs` entries at phase 7's K3/K4/fused call shapes
    (`batch_call_inputs`): the PSD repair's blocks (h, None), each fused
    launch's (h, b), and for each K4 call (L L^T, b)."""
    calls = batch_call_inputs(device)
    return ([(a[0], None) for _, a, _ in calls["mod_chol"]]
            + [(a[0], a[1]) for _, a, _ in calls["factor_solve"]]
            + [((a[0] @ a[0].transpose(-1, -2)).contiguous(), a[1]) for _, a, _ in calls["chol_solve"]])


def check_chol_calls(device, log, calls):
    """K3, K4 and the fused kernel on a path's own inputs (``calls``, from
    `step_call_inputs`), each call as the path makes it (its ``gmw`` and
    ``want_l``), against the plain version on the same inputs: e within
    1e-4 relative of plain's and L too, |L L^T - (h + diag e)| within
    1e-5 |h| or twice plain's; x within 1e-3 relative of plain's or its
    residual (on h + diag e for the fused launch, on L L^T for K4) within
    1e-5 or twice plain's; the fused launch bit-equal to K3 then K4 (the
    same arithmetic in one launch) and ``want_l=False`` changing no e or x.
    Returns the largest abs errors (K3, K4, fused)."""
    import torch
    from trajopt_tpu_torch.ops import cuda_chol

    errs = [0.0, 0.0, 0.0]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)) if b.numel() else 0.0

    def factor_check(name, h, gmw):
        l, e = cuda_chol.mod_chol(h, gmw=gmw)
        _, e_only = cuda_chol.mod_chol(h, gmw=gmw, want_l=False)
        _sync(device)
        pl, pe = cuda_chol.mod_chol_plain(h, gmw=gmw)
        check(torch.equal(e_only, e), f"K3 {name}: want_l=False changes e")
        ee = rel(e, pe) if bool((pe != 0).any()) else float(e.abs().max())
        el = rel(l, pl)
        hd = h.double()
        scale = float(torch.linalg.matrix_norm(hd).max()) or 1.0
        target = hd + torch.diag_embed(e.double())
        rec = float(torch.linalg.matrix_norm(l.double() @ l.double().transpose(-1, -2) - target).max()) / scale
        rec_plain = float(torch.linalg.matrix_norm(
            pl.double() @ pl.double().transpose(-1, -2) - hd - torch.diag_embed(pe.double())).max()) / scale
        check(ee <= 1e-4, f"K3 {name}: e differs from plain by {ee:.3g} relative")
        check(el <= 1e-4, f"K3 {name}: L differs from plain by {el:.3g} relative")
        check(rec <= max(1e-5, 2.0 * rec_plain),
              f"K3 {name}: |L L^T - (h + diag e)| / |h| = {rec:.3g} (plain {rec_plain:.3g})")
        errs[0] = max(errs[0], float((l - pl).abs().max()), float((e - pe).abs().max()))
        return l, e, pe, ee, el, rec

    for name, (h,), kw in calls["mod_chol"]:
        l, e, pe, ee, el, rec = factor_check(name, h, kw.get("gmw", True))
        log(f"  K3 mod_chol {name}: e vs plain {ee:.2e}, L vs plain {el:.2e}, recon {rec:.2e} "
            f"({int((pe != 0).any(-1).sum())} boosted blocks of {pe.shape[:-1].numel()})")
    for name, (l, rhs), _ in calls["chol_solve"]:
        x = cuda_chol.chol_solve(l, rhs)
        _sync(device)
        px = cuda_chol.chol_solve_plain(l, rhs)
        dx = rel(x, px)
        ld = l.double()
        res, res_plain = (_residual(ld, v.double(), rhs.double()) for v in (x, px))
        check(dx <= 1e-3 or res <= max(1e-5, 2.0 * res_plain),
              f"K4 {name}: x differs from plain by {dx:.3g} relative, residual {res:.3g} "
              f"(plain {res_plain:.3g})")
        errs[1] = max(errs[1], float((x - px).abs().max()))
        log(f"  K4 chol_solve {name}: x vs plain {dx:.2e}, residual {res:.2e} (plain {res_plain:.2e})")
    for name, (h, rhs), kw in calls["factor_solve"]:
        gmw = kw.get("gmw", True)
        l, e, pe, ee, el, rec = factor_check(name, h, gmw)
        lf, ef, xf = cuda_chol.factor_solve(h, rhs, gmw=gmw)
        none, ef2, xf2 = cuda_chol.factor_solve(h, rhs, gmw=gmw, want_l=False)
        x = cuda_chol.chol_solve(l, rhs)
        _sync(device)
        check(torch.equal(lf, l) and torch.equal(ef, e) and torch.equal(xf, x),
              f"fused {name}: differs from K3 then K4")
        check(none is None and torch.equal(ef2, ef) and torch.equal(xf2, xf),
              f"fused {name}: want_l=False changes e or x")
        pl, pe2, px = cuda_chol.factor_solve_plain(h, rhs, gmw=gmw)
        dx = rel(xf, px)
        system = h.double() + torch.diag_embed(pe2.double())
        res, res_plain = (_system_residual(system, v.double(), rhs.double()) for v in (xf, px))
        check(dx <= 1e-3 or res <= max(1e-5, 2.0 * res_plain),
              f"fused {name}: x differs from plain by {dx:.3g} relative, residual {res:.3g} "
              f"(plain {res_plain:.3g})")
        errs[2] = max(errs[2], float((lf - pl).abs().max()), float((ef - pe2).abs().max()),
                      float((xf - px).abs().max()))
        log(f"  fused factor_solve {name}: bit-equal to K3 then K4; e vs plain {ee:.2e}, L vs "
            f"plain {el:.2e}, x vs plain {dx:.2e}, residual {res:.2e} (plain {res_plain:.2e})")
    return tuple(errs)


def topk_cases(device, rng):
    """(name, x, k) at the single-UAV and 64-robot slice shapes plus ties and
    short rows, then `testing.topk_edge_rows`, then the ``optimal_plane``
    path's own call shapes (`optimal_plane_inputs`), then phase 7's
    (`batch_call_inputs`)."""
    import numpy as np
    from trajopt_tpu_torch.testing import EDGE_SEED, topk_edge_rows

    t = _f32(device)

    def dists(shape, inf_frac):
        a = rng.random(shape) ** 2 * 10.0
        a[rng.random(shape) < inf_frac] = np.inf
        return a

    ties = np.round(rng.random((8, 1000)) * 20.0)
    short = np.full((4, 100), np.inf)
    short[:, rng.choice(100, 5, replace=False)] = rng.random(5)
    self_d2 = dists((FLEET, FLEET_PIECES, 8, FLEET), 0.0)
    self_d2[np.arange(FLEET), :, :, np.arange(FLEET)] = np.inf
    edges = [(name, t(a), k) for name, a, k in topk_edge_rows(np.random.default_rng(EDGE_SEED))]
    # call shapes of the P=16 and the decoupled solves, from their own
    # generator so that the cases above keep their inputs
    g = np.random.default_rng(EDGE_SEED + 2)
    d2 = g.random((FLEET, FLEET_PIECES, 8, FLEET)) ** 2 * 10.0
    d2[np.arange(FLEET), :, :, np.arange(FLEET)] = np.inf
    more = [
        ("P=16 coarse [16,20000] k=64", t(g.random((16, N_POINTS)) ** 2 * 10.0), 64),
        ("P=16 clearance [16,8,20000] k=8", t(g.random((16, 8, N_POINTS)) ** 2 * 10.0), 8),
        ("fleet ccd level2 [64,16] k=9", t(g.random((FLEET, 16)) ** 2 * 10.0), 9),
        ("decoupled pair ccd [64,4,8,64] k=8", t(d2 + np.round(g.random(d2.shape) * 4.0)), 8),
        ("P=16 fine [16,8,64] k=16", t(g.random((16, 8, 64)) ** 2 * 10.0), 16),
    ]
    return [
        ("coarse [4,20000] k=64", t(dists((4, N_POINTS), 0.1)), 64),
        ("fine [32,64] k=16", t(dists((32, 64), 0.2)), 16),
        ("clearance [32,20000] k=8", t(dists((32, N_POINTS), 0.0)), 8),
        ("ccd segments [1,32] k=32", t(dists((1, 32), 0.5)), 32),
        ("ccd level1 [32,20000] k=17", t(dists((32, N_POINTS), 0.3)), 17),
        ("ccd level2 [32,16] k=9", t(dists((32, 16), 0.3)), 9),
        ("ties [8,1000] k=50", t(ties), 50),
        ("few finite [4,100] k=20", t(short), 20),
        ("fleet pieces [1,256] k=32", t(dists((1, 256), 0.5)), 32),
        ("fleet coarse [32,4000] k=64", t(dists((32, FLEET_POINTS), 0.0)), 64),
        ("fleet segments [32,8,64] k=16", t(dists((32, 8, 64), 0.1)), 16),
        ("self planes [64,4,8,64] k=4", t(self_d2), 4),
        ("pair ccd [64,4,8,64] k=9", t(self_d2 + np.round(dists(self_d2.shape, 0.0))), 9),
        ("pair ccd level2 [64,4,8,8] k=5", t(dists((FLEET, FLEET_PIECES, 8, 8), 0.3)), 5),
        ("obstacle ccd segments [1,2048] k=64", t(dists((1, 2048), 0.5)), 64),
        ("obstacle ccd level1 [64,4000] k=17", t(dists((64, FLEET_POINTS), 0.3)), 17),
    ] + more + edges + optimal_plane_inputs(device)[0] + [
        (name, x.contiguous(), k) for name, (x, k), _ in batch_call_inputs(device)["smallest_k"]]


def check_topk(device, rng, log):
    """K1 against its plain version (a stable sort) run on the CPU on the
    same inputs, bit for bit: values as int32 bit patterns (-0.0 and NaN
    included) and indices.  The CPU sort compares floats, so -0.0 ties with
    +0.0 there; whether the card's own sort agrees is logged, not required."""
    import torch
    from trajopt_tpu_torch.ops import cuda_topk

    err = 0.0
    for name, x, k in topk_cases(device, rng):
        v, i = cuda_topk.smallest_k(x, k)
        _sync(device)
        pv, pi = cuda_topk.smallest_k_plain(x.cpu(), k)
        v, i = v.cpu(), i.cpu()
        check(torch.equal(v.view(torch.int32), pv.view(torch.int32)),
              f"K1 {name}: values differ from the plain version")
        check(torch.equal(i, pi), f"K1 {name}: indices differ from the plain version")
        cv, ci = cuda_topk.smallest_k_plain(x, k)
        card_sort = torch.equal(cv.cpu().view(torch.int32), pv.view(torch.int32)) and \
            torch.equal(ci.cpu(), pi)
        fin = torch.isfinite(pv)
        err = max(err, float((v[fin] - pv[fin]).abs().max()) if fin.any() else 0.0)
        log(f"  K1 smallest_k {name}, route {cuda_topk.route(x.shape[-1], k)}: values (bits) "
            f"and indices equal{'' if card_sort else ' (the card sort differs from the CPU sort)'}")
    return err


def gjk_cases(device, rng, pair_diffs):
    """(name, u, iters, brute rows): the brute-force oracle runs on the
    first ``brute rows`` problems of each case (it is cubic-to-quartic in m).
    The last cases are the ``optimal_plane`` full tables
    (`optimal_plane_inputs`), then phase 7's inputs (`batch_call_inputs`),
    held by `check_gjk_paths`: on the solver's own data the lb of a few
    problems parts from plain's (the CCD's, by up to 2.3e-4 x max|u| on an
    H100, either way), as on the pair cases of `gjk_callsite_cases`."""
    import numpy as np
    from trajopt_tpu_torch.testing import EDGE_SEED, gjk_edge_sets

    t = _f32(device)
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
    ha = rng.normal(size=(1024, 6, 3)) * 0.3
    hb = rng.normal(size=(1024, 6, 3)) * 0.3 + rng.normal(size=(1024, 1, 3)) * 0.8
    self_pairs = (ha[:, :, None] - hb[:, None]).reshape(1024, 36, 3)
    return [
        ("plane fit [512,6,3] iters=16", t(hulls - pts), 16, 512),
        ("ccd level3 [256,6,3] iters=16", t(far), 16, 256),
        ("clearance [256,6,3] iters=32", t(far[:, ::-1]), 32, 256),
        ("collinear [128,6,3]", t(collinear), 16, 128),
        ("coplanar [128,6,3]", t(coplanar), 16, 128),
        ("coincident [128,6,3]", t(coincident), 16, 128),
        ("self planes [1024,36,3] iters=16", t(self_pairs), 16, 8),
        (f"fleet pairs {list(pair_diffs.shape)} iters=48 (64-robot start)", pair_diffs, 48, 8),
    ] + gjk_callsite_cases(device) + [
        (name, t(u), iters, n_brute)
        for name, u, iters, n_brute in gjk_edge_sets(np.random.default_rng(EDGE_SEED + 1))
    ] + optimal_plane_inputs(device)[1] + [
        (name, u, iters, None) for name, (u, iters), _ in batch_call_inputs(device)["gjk_exact"]]


def gjk_callsite_cases(device):
    """K2 at the call shapes of the P=16 and the 64-robot solves that the
    cases above lack (own generator): plane fits [1024,6,3], and pair CCD
    between separated hulls (the solver keeps robots apart) at [8192,36,3]
    (6-point hulls) and [16384,144,3] (12-point hulls, the m > 64 path).
    The pair cases have None brute rows: `check_gjk_paths` holds their lb
    to plain's tightness and to the float64 converged distance, not to
    plain's path."""
    import numpy as np
    from trajopt_tpu_torch.testing import EDGE_SEED

    t = _f32(device)
    g = np.random.default_rng(EDGE_SEED + 3)

    def pairs(n, m):
        ha = g.normal(size=(n, m, 3)) * 0.3
        way = g.normal(size=(n, 1, 3))
        way *= (2.2 + np.abs(g.normal(size=(n, 1, 1))) * 0.5) / np.linalg.norm(way, axis=2, keepdims=True)
        hb = g.normal(size=(n, m, 3)) * 0.3 + way
        return (ha[:, :, None] - hb[:, None]).reshape(n, m * m, 3)

    planes = g.normal(size=(1024, 6, 3)) * 0.3 - g.normal(size=(1024, 1, 3)) * 1.5
    return [
        ("P=16 plane fit [1024,6,3] iters=16", t(planes), 16, 64),
        ("coupled pair ccd [8192,36,3] iters=16", t(pairs(8192, 6)), 16, None),
        ("decoupled pair ccd [16384,144,3] iters=16", t(pairs(16384, 12)), 16, None),
    ]


def check_gjk(device, rng, pair_diffs, log):
    import torch
    from trajopt_tpu_torch.ops import cuda_gjk
    from trajopt_tpu_torch.testing import brute_origin_dist

    err = 0.0
    for name, u, iters, n_brute in gjk_cases(device, rng, pair_diffs):
        hd = cuda_gjk.gjk_exact(u, iters)
        _sync(device)
        ref = cuda_gjk.gjk_exact_plain(u, iters)
        scale = u.abs().amax(dim=(1, 2))
        if n_brute is None:
            err = max(err, check_gjk_paths(name, u, iters, hd, ref, scale, log))
            continue
        # where the origin touches or lies in the hull, lb is a path-dependent
        # non-positive number (no separation certificate): only its soundness
        # is compared there
        sep = ref.dist > 1e-3 * scale
        e_dist = (hd.dist - ref.dist).abs() / scale
        e_lb = torch.where(sep, (hd.lb - ref.lb).abs() / scale, 0.0)
        check(bool((e_dist <= 1e-5).all()),
              f"K2 {name}: dist differs from plain by {float(e_dist.max()):.3g} x scale")
        check(bool((e_lb <= 1e-5).all()),
              f"K2 {name}: lb differs from plain by {float(e_lb.max()):.3g} x scale")
        over = float("-inf")
        if n_brute:
            true = torch.as_tensor(brute_origin_dist(u[:n_brute].double().cpu().numpy()), device=device)
            over = float(((hd.lb[:n_brute].double() - true) / scale[:n_brute].double()).max())
        check(over <= 1e-6, f"K2 {name}: lb exceeds the true distance by {over:.3g} x scale")
        err = max(err, float((hd.dist - ref.dist).abs().max()),
                  float(torch.where(sep, (hd.lb - ref.lb).abs(), 0.0).max()))
        log(f"  K2 gjk_exact {name}: |dist-plain|/scale {float(e_dist.max()):.2e}, "
            f"|lb-plain|/scale {float(e_lb.max()):.2e} ({int(sep.sum())} separated of {len(sep)}), "
            f"max (lb-true)/scale {float(over):.2e} on {n_brute}")
    return err


def check_gjk_paths(name, u, iters, hd, ref, scale, log):
    """K2 on a case where the lb of a few problems parts from the plain
    version's.  A problem stops once its support score is within 100
    float32 epsilons of |v|^2 (or its support vertex is already in the
    simplex), and lb is the best support score over |v|; where in that
    window the last score falls is decided by float32 rounding, which the
    kernel and plain take in another order (fused multiply-adds against a
    batched matmul for the scores).  At distances near max|u| the window is
    a few 1e-5 x max|u|: on the pair cases the lb of 3 of 8192 and 13 of
    16384 problems parts from plain's by more than 1e-5 x max|u| (up to
    8.8e-5 and 1.2e-4), and the earlier one-thread-per-problem design of
    this kernel parts on the same cases by the same amounts.  So dist is
    held to plain as elsewhere (within 1e-5 x max|u|), both are sound
    against the float64 converged distance (plain, 64 iterations) to 1e-6 x
    max|u|, and the brackets dist - lb of the separated problems are as
    tight as plain's: median and maximum within twice plain's + 1e-5 x
    max|u|.  The control: the kernel one round short of its own last round
    on this data (the fewest iterations whose output equals the full run's,
    less one) must fail that test.  On phase 7's inputs (names "phase 7
    ..."), the solver's own data, most problems stop within a few rounds
    and the few that run longer leave brackets at one round short that the
    test cannot tell from the full run's: there the control is logged, not
    required.  Returns the largest |kernel - plain| on the separated
    problems."""
    import torch
    from trajopt_tpu_torch.ops import cuda_gjk

    e_dist = float(((hd.dist - ref.dist).abs() / scale).max())
    check(e_dist <= 1e-5, f"K2 {name}: dist differs from plain by {e_dist:.3g} x scale")
    true = cuda_gjk.gjk_exact_plain(u.double(), 64).dist
    sc = scale.double()
    sep = ref.lb > 1e-3 * scale
    unsound = {}
    for who, h in (("kernel", hd), ("plain", ref)):
        under = float(((true - h.dist.double()) / sc).max())
        over = float(((h.lb.double() - true) / sc).max())
        check(under <= 1e-6, f"K2 {name}: {who} dist is below the converged distance by {under:.3g} x scale")
        check(over <= 1e-6, f"K2 {name}: {who} lb exceeds the converged distance by {over:.3g} x scale")
        unsound[who] = max(under, over)

    def width(h):
        return ((h.dist.double() - h.lb.double()) / sc)[sep]

    def faults(h, tol=1e-5):
        got, want = width(h), width(ref)
        return [f"{stat} dist-lb {float(f(got)):.3g} > 2 x plain's {float(f(want)):.3g} + {tol:g}"
                for stat, f in (("median", torch.median), ("max", torch.max))
                if float(f(got)) > 2.0 * float(f(want)) + tol]

    found = faults(hd)
    check(not found, f"K2 {name}: brackets looser than plain's: {'; '.join(found)}")
    last = next(r for r in range(1, iters + 1) if all(
        torch.equal(a, b) for a, b in zip(cuda_gjk.gjk_exact(u, r), hd)))
    short = faults(cuda_gjk.gjk_exact(u, last - 1)) if last > 1 else []
    control = not name.startswith("phase 7")
    check(short or not control,
          f"K2 {name}: the tightness test does not tell {last - 1} iterations from {iters}")
    parted = int(((hd.lb - ref.lb).abs() > 1e-5 * scale)[sep].sum())
    told = f"fails: {short[0]}" if short else "is not told from the full run (not required)"
    log(f"  K2 gjk_exact {name}: |dist-plain|/scale {e_dist:.2e}; lb of {parted} of "
        f"{int(sep.sum())} separated problems parts from plain's by > 1e-5 x scale (max "
        f"{float(((hd.lb - ref.lb).abs() / scale)[sep].max()):.2e}); dist-lb median/max /scale kernel "
        f"{float(width(hd).median()):.1e}/{float(width(hd).max()):.1e}, plain "
        f"{float(width(ref).median()):.1e}/{float(width(ref).max()):.1e}; control at {last - 1} of "
        f"{last} rounds {told}; against the float64 converged distance: max unsoundness "
        f"kernel {unsound['kernel']:.1e}, plain {unsound['plain']:.1e}")
    return float(torch.maximum((hd.dist - ref.dist).abs(), (hd.lb - ref.lb).abs())[sep].max())


def fw_cases(device, rng, pair_diffs):
    """(name, entry point call(iters), difference set u, iters, brute rows)
    for K5 at m = 6, 12 and 36, at the pairwise-clearance cross-check's
    shape, then `testing.fw_edge_sets` (m = 1 to 513, every tier of
    `cuda_gjk.fw_route`; own generator, so the other cases keep their
    inputs).  ``brute rows``: how many leading problems `brute_origin_dist`
    checks; 0 holds every problem to the float64 converged exact distance
    instead."""
    import numpy as np
    from trajopt_tpu_torch.ops import cuda_gjk
    from trajopt_tpu_torch.testing import EDGE_SEED, fw_edge_sets

    t = _f32(device)
    shift = np.array([0.5, 0.2, -0.1])
    rand = {m: t(rng.normal(size=(n, m, 3)) + shift) for n, m in ((256, 6), (130, 12), (64, 36))}
    a = t(rng.normal(size=(128, 6, 3)))
    b = t(rng.normal(size=(128, 6, 3)) + np.array([4.0, 0.0, 0.0]))
    verts = t(rng.normal(size=(128, 12, 3)))
    inside = verts.mean(dim=1)
    coincident = t(np.repeat(rng.normal(size=(128, 6, 3)), 2, axis=1) + rng.normal(size=(128, 1, 3)))
    coplanar = rng.normal(size=(128, 36, 3))
    coplanar[..., 2] = 0.4 * rng.choice([-1.0, 1.0], size=(128, 1))
    coplanar = t(coplanar)
    cases = [(f"random {list(u.shape)}", u, 24 if m == 6 else 32, None) for m, u in rand.items()]
    cases += [
        ("separated pairs [128,6]x[128,6]", (a, b), 32, None),
        ("points inside [128,12,3]", (verts, inside), 32, None),
        ("coincident [128,12,3]", coincident, 32, None),
        ("coplanar [128,36,3]", coplanar, 32, None),
        (f"fleet pairs {list(pair_diffs.shape)} (64-robot start)", pair_diffs, 32, None),
    ]
    cases += [(name, tuple(map(t, x)) if isinstance(x, tuple) else t(x), iters, n_brute)
              for name, x, iters, n_brute in fw_edge_sets(np.random.default_rng(EDGE_SEED + 4))]
    out = []
    for name, x, iters, n_brute in cases:
        if isinstance(x, tuple) and x[1].ndim == 3:
            call = lambda it, x=x: cuda_gjk.gjk_pairs(x[0], x[1], it)
            u = (x[0][:, :, None] - x[1][:, None]).reshape(x[0].shape[0], -1, 3).contiguous()
        elif isinstance(x, tuple):
            call = lambda it, x=x: cuda_gjk.gjk_points(x[0], x[1], it)
            u = (x[0] - x[1][:, None]).contiguous()
        else:
            call = lambda it, x=x: cuda_gjk.gjk_diffset(x, it)
            u = x
        if n_brute is None:
            n_brute = 32 if u.shape[1] <= 12 else 8
        out.append((name, call, u, iters, n_brute))
    return out


def fw_looseness(h, scale, true, sep):
    """K5 result ``h``: (dist - lb) / scale on the problems ``sep`` the plain
    version certifies separated, and (dist - true) / scale on the first
    len(true) problems (float64)."""
    n = len(true)
    return {"dist-lb": ((h.dist.double() - h.lb.double()) / scale)[sep],
            "dist-true": (h.dist[:n].double() - true) / scale[:n]}


def fw_tightness_faults(hd, ref, ref_half, scale, true, sep, tol=1e-5):
    """Where K5's brackets after ``iters`` rounds are looser than the plain
    version's: at the median, each looseness of ``fw_looseness`` may exceed
    twice plain's after the same rounds by ``tol``; at the maximum, plain's
    after half the rounds by ``tol``.  (The maximum over a case is set by
    the few problems whose paths part most, which can land 10x apart between
    two correct implementations; half the rounds is looser than that.)"""
    faults = []
    got, want, half = (fw_looseness(h, scale, true, sep) for h in (hd, ref, ref_half))
    for key, k in got.items():
        if k.numel() == 0:
            continue
        med, med_ref = float(k.median()), float(want[key].median())
        top, top_half = float(k.max()), float(half[key].max())
        if med > 2.0 * med_ref + tol:
            faults.append(f"median {key} {med:.3g} > 2 x plain {med_ref:.3g} + {tol:g}")
        if top > top_half + tol:
            faults.append(f"max {key} {top:.3g} > plain at half the rounds {top_half:.3g} + {tol:g}")
    return faults


def check_fw(device, rng, pair_diffs, log):
    """K5 against its plain version.  Frank-Wolfe with the away step meets
    exact ties by construction: after an exact line search on an edge, both
    ends score u.v = |v|^2, and rounding (sums taken in another order, the
    trial points in closed form) picks the away vertex.  So kernel and plain
    agree to rounding for one round only.  After the full rounds each case
    must meet: the brackets [lb, dist] of kernel and plain intersect and
    contain the float64 brute-force distance (the float64 converged exact
    distance where the case has no brute rows); the kernel's brackets are
    as tight as plain's (`fw_tightness_faults`), and the kernel's own
    one-round output fails that test (the control; with one vertex every
    round returns that vertex, so there is nothing for it to tell); and
    from ``iters - 1`` to ``iters`` rounds the kernel's lb does not fall nor
    its dist rise beyond 1e-6 x scale."""
    import torch
    from trajopt_tpu_torch.ops import cuda_gjk
    from trajopt_tpu_torch.testing import brute_origin_dist

    err = 0.0
    for name, call, u, iters, n_brute in fw_cases(device, rng, pair_diffs):
        scale = u.abs().amax(dim=(1, 2))
        one = call(1)
        _sync(device)
        ref1 = cuda_gjk.gjk_fw_plain(u, 1)
        e1 = torch.maximum((one.dist - ref1.dist).abs(), (one.lb - ref1.lb).abs()) / scale
        check(bool((e1 <= 1e-5).all()),
              f"K5 {name}: one round differs from plain by {float(e1.max()):.3g} x scale")
        err = max(err, float(torch.maximum((one.dist - ref1.dist).abs(),
                                           (one.lb - ref1.lb).abs()).max()))
        hd, prev = call(iters), call(iters - 1)
        _sync(device)
        ref, ref_half = cuda_gjk.gjk_fw_plain(u, iters), cuda_gjk.gjk_fw_plain(u, iters // 2)
        gap = torch.maximum(hd.lb - ref.dist, ref.lb - hd.dist) / scale
        check(bool((gap <= 1e-5).all()),
              f"K5 {name}: kernel and plain brackets are {float(gap.max()):.3g} x scale apart")
        if n_brute:
            true = torch.as_tensor(brute_origin_dist(u[:n_brute].double().cpu().numpy()), device=device)
        else:
            n_brute = u.shape[0]
            true = cuda_gjk.gjk_exact_plain(u.double(), 64).dist
        sc = scale[:n_brute].double()
        over = float(((hd.lb[:n_brute].double() - true) / sc).max())
        under = float(((true - hd.dist[:n_brute].double()) / sc).max())
        check(over <= 1e-5, f"K5 {name}: lb exceeds the true distance by {over:.3g} x scale")
        check(under <= 1e-5, f"K5 {name}: dist is below the true distance by {under:.3g} x scale")
        sep = ref.lb > 1e-3 * scale
        dscale = scale.double()
        faults = fw_tightness_faults(hd, ref, ref_half, dscale, true, sep)
        check(not faults, f"K5 {name}: brackets looser than plain's: {'; '.join(faults)}")
        control = fw_tightness_faults(one, ref, ref_half, dscale, true, sep)
        check(control or u.shape[1] == 1,
              f"K5 {name}: the tightness test does not tell one round from {iters}")
        lb_drop = float(((prev.lb - hd.lb) / scale).max())
        dist_rise = float(((hd.dist - prev.dist) / scale).max())
        check(lb_drop <= 1e-6, f"K5 {name}: lb falls by {lb_drop:.3g} x scale in round {iters}")
        check(dist_rise <= 1e-6, f"K5 {name}: dist rises by {dist_rise:.3g} x scale in round {iters}")
        loose = {key: " ".join(f"{float(v.median()):.1e}/{float(v.max()):.1e}" if v.numel() else "-"
                               for v in (kv, rv))
                 for (key, kv), rv in zip(fw_looseness(hd, dscale, true, sep).items(),
                                          fw_looseness(ref, dscale, true, sep).values())}
        log(f"  K5 gjk_fw {name}, route {cuda_gjk.fw_route(u.shape[1], u.shape[0])}: 1 round "
            f"|kernel-plain|/scale {float(e1.max()):.2e}; "
            f"{iters} rounds: brackets apart {float(gap.max()):.2e} x scale, "
            f"median/max /scale kernel plain: {loose} "
            f"({int(sep.sum())} separated, true on {n_brute}), "
            f"max (lb-true)/scale {over:.2e}, max (true-dist)/scale {under:.2e}, "
            f"last round lb drop {lb_drop:.1e}, dist rise {dist_rise:.1e}; control: "
            f"{control[0] if control else 'none at m = 1'}")
    return err


def chol_cases(device, rng):
    import numpy as np

    t = _f32(device)

    def spd(b, m, cond):
        q, _ = np.linalg.qr(rng.normal(size=(b, m, m)))
        ev = np.logspace(0, np.log10(cond), m)
        return np.einsum("bij,j,bkj->bik", q, ev, q)

    sym = rng.normal(size=(4, 19, 19))
    indefinite = sym + sym.transpose(0, 2, 1)
    sym = rng.normal(size=(256, 19, 19))
    return [
        ("PD [4,19,19] cond 1e2", t(spd(4, 19, 1e2)), True),
        ("indefinite [4,19,19]", t(indefinite), False),
        ("KKT-like [1,33,33] cond 1e2", t(spd(1, 33, 1e2)), True),
        ("KKT-like [1,33,33] cond 1e6", t(spd(1, 33, 1e6)), True),
        ("fleet pieces PD [256,19,19] cond 1e2", t(spd(256, 19, 1e2)), True),
        ("fleet pieces indefinite [256,19,19]", t(sym + sym.transpose(0, 2, 1)), False),
        ("fleet KKT [64,33,33] cond 1e6", t(spd(FLEET, 33, 1e6)), True),
    ]


def chol_edge_cases(device):
    """`testing.chol_edge_blocks` on the card (own generator, so that the
    cases above keep their inputs): (name, h, positive definite)."""
    import numpy as np
    from trajopt_tpu_torch.testing import EDGE_SEED, chol_edge_blocks

    t = _f32(device)
    return [(name, t(h), kind == "pd")
            for name, h, kind in chol_edge_blocks(np.random.default_rng(EDGE_SEED + 4))]


def check_chol(device, rng, log):
    """K3 against its plain version on the call-site shapes and the edge
    blocks: L and e within 1e-4 relative, |L L^T - (h + diag e)| within
    1e-5 |h| (on the indefinite edge blocks, twice the plain version's if
    that is more), no boost on a positive-definite block, ``gmw=False`` equal to
    the GMW factor there and NaN where plain's is NaN elsewhere (but 0 on
    the diagonal at a zero pivot), zeros above
    the diagonal, and ``want_l=False`` giving the same e bit for bit.
    Returns the largest abs error and, for every case, (name, h, the
    kernel's l and e, plain's l and e)."""
    import torch
    from trajopt_tpu_torch.ops import cuda_chol

    err = 0.0
    factors = []
    for name, h, pd in chol_cases(device, rng) + chol_edge_cases(device):
        l, e = cuda_chol.mod_chol(h)
        none, e_only = cuda_chol.mod_chol(h, want_l=False)
        _sync(device)
        pl, pe = cuda_chol.mod_chol_plain(h)
        check(none is None and torch.equal(e_only, e), f"K3 {name}: want_l=False changes e")
        check(bool((l.triu(1) == 0).all()), f"K3 {name}: L is not lower triangular")
        if pd:
            check(bool((e == 0).all()) and bool((pe == 0).all()),
                  f"K3 {name}: GMW boosted a positive-definite block")
        hd = h.double()
        rec = l.double() @ l.double().transpose(-1, -2)
        target = hd + torch.diag_embed(e.double())
        # relative to |h|; a zero block has only its boosts to be relative to
        scale = torch.linalg.matrix_norm(hd).max()
        scale = scale if scale > 0 else torch.linalg.matrix_norm(target).max()
        rel = float(torch.linalg.matrix_norm(rec - target).max() / scale)
        # the boosts of an indefinite block can dwarf |h|: there the plain
        # version's own reconstruction error is the floor, as for K4
        rec_plain = pl.double() @ pl.double().transpose(-1, -2) - hd - torch.diag_embed(pe.double())
        rel_plain = float(torch.linalg.matrix_norm(rec_plain).max() / scale)
        bound = max(1e-5, 2.0 * rel_plain) if name.startswith("edge") and not pd else 1e-5
        check(rel <= bound, f"K3 {name}: |L L^T - (h + diag e)| / |h| = {rel:.3g} "
                            f"(plain {rel_plain:.3g})")
        el = float((l - pl).abs().max() / pl.abs().max())
        ee = float((e - pe).abs().max() / max(float(pe.abs().max()), 1e-30)) if bool((pe != 0).any()) else float(e.abs().max())
        check(el <= 1e-4, f"K3 {name}: L differs from plain by {el:.3g} relative")
        check(ee <= 1e-4, f"K3 {name}: e differs from plain by {ee:.3g} relative")
        lp, ep = cuda_chol.mod_chol(h, gmw=False)
        _sync(device)
        check(bool((ep == 0).all()), f"K3 {name}: gmw=False returned a boost")
        if pd:
            check(bool(torch.isfinite(lp).all()), f"K3 {name}: plain Cholesky mode failed on a PD block")
            dp = float((lp - l).abs().max() / l.abs().max())
            check(dp <= 1e-5, f"K3 {name}: gmw=False differs on a PD block by {dp:.3g}")
        else:
            ref = cuda_chol.mod_chol_plain(h, gmw=False)[0]
            check(bool(ref.isnan().any()), f"K3 {name}: plain Cholesky of a non-PD block has no NaN")
            # at a pivot of exactly 0 the kernel stores sqrt(0) = 0 on the
            # diagonal where the plain version divides 0 by it (NaN); the
            # column below is NaN in both
            same = (lp.isnan() == ref.isnan()) | (ref.isnan() & (lp == 0) & torch.eye(
                h.shape[-1], dtype=torch.bool, device=device))
            check(bool(same.all()),
                  f"K3 {name}: gmw=False puts its NaNs elsewhere than the plain version")
            fin = ~ref.isnan()
            dn = float((lp[fin] - ref[fin]).abs().max() / ref[fin].abs().max().clamp(min=1e-30)) if fin.any() else 0.0
            check(dn <= 1e-4, f"K3 {name}: gmw=False differs from plain before the NaNs by {dn:.3g}")
        err = max(err, float((l - pl).abs().max()), float((e - pe).abs().max()))
        factors.append((name, h, l, e, pl, pe))
        log(f"  K3 mod_chol {name}, route {cuda_chol.route(h.shape[-1])}: recon {rel:.2e}, "
            f"L vs plain {el:.2e}, e vs plain {ee:.2e}")
    return err, factors


def _columns(a, v):
    """``v`` as columns for ``a`` [..., m, m]: a vector right-hand side
    [..., m] gets a last axis of 1."""
    return v[..., None] if v.ndim == a.ndim - 1 else v


def _residual(l, x, b):
    """|L L^T x - b| / |b| in float64."""
    xm, bm = _columns(l, x), _columns(l, b)
    return float((l @ (l.transpose(-1, -2) @ xm) - bm).norm() / bm.norm())


def _system_residual(a, x, b):
    """|A x - b| / |b| in float64."""
    xm, bm = _columns(a, x), _columns(a, b)
    return float((a @ xm - bm).norm() / bm.norm())


def check_solve(device, rng, factors, log):
    """K4 on K3's factors, and the fused kernel on the same blocks and
    right-hand sides.  K4: residual |L L^T x - b| / |b| within 1e-5 (on
    ill-conditioned factors twice the plain version's), x within 1e-3
    relative of plain.  Fused: L, e and x bit-equal to K3's and K4's (the
    same arithmetic in one launch), which holds it to `mod_chol_plain` then
    `chol_solve_plain` at K3's and K4's tolerances, and x within 1e-3
    relative of plain-then-plain's or, on ill-conditioned blocks, its
    residual on h + diag e within twice plain-then-plain's;
    ``want_l=False`` the same e and x.  Returns the largest abs errors (K4, fused)."""
    import numpy as np
    import torch
    from trajopt_tpu_torch.ops import cuda_chol
    from trajopt_tpu_torch.testing import EDGE_SEED, chol_edge_rhs

    err = err_fused = 0.0
    edge_rng = np.random.default_rng(EDGE_SEED + 5)
    for name, h, l, e, pl, pe in factors:
        b, m = l.shape[0], l.shape[-1]
        if name.startswith("edge"):      # all four layouts, from their own generator
            sides = chol_edge_rhs(edge_rng, h)
        else:                            # the call sites' layouts
            sides = [rng.normal(size=shape)
                     for shape in ([(b, m), (b, m, 2)] if m == 33 else [(b, m)])]
        for side in sides:
            rhs, shape = torch.as_tensor(side, dtype=torch.float32, device=device), side.shape
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

            lf, ef, xf = cuda_chol.factor_solve(h, rhs)
            none, ef2, xf2 = cuda_chol.factor_solve(h, rhs, want_l=False)
            _sync(device)
            check(torch.equal(lf, l) and torch.equal(ef, e) and torch.equal(xf, x),
                  f"fused {name} rhs {shape}: differs from K3 then K4")
            check(none is None and torch.equal(ef2, e) and torch.equal(xf2, x),
                  f"fused {name} rhs {shape}: want_l=False changes e or x")
            fx = cuda_chol.chol_solve_plain(pl, rhs)       # plain then plain
            dfx = float((xf - fx).abs().max() / fx.abs().max())
            # each x solves its own float32 factorization of h + diag e, so
            # on an ill-conditioned block the two part by eps x cond; both
            # are then held to the system itself, in float64
            system = h.double() + torch.diag_embed(pe.double())
            res_f, res_fp = (_system_residual(system, v.double(), rhs.double()) for v in (xf, fx))
            check(dfx <= 1e-3 or res_f <= max(1e-5, 2.0 * res_fp),
                  f"fused {name} rhs {shape}: x differs from plain by {dfx:.3g} relative, "
                  f"residual {res_f:.3g} (plain {res_fp:.3g})")
            err_fused = max(err_fused, float((lf - pl).abs().max()), float((ef - pe).abs().max()),
                            float((xf - fx).abs().max()))
            log(f"  K4 chol_solve L {name} rhs {list(shape)}: residual {res:.2e} "
                f"(plain {res_plain:.2e}), x vs plain {dx:.2e}; fused: bit-equal to K3 then K4, "
                f"x vs plain-then-plain {dfx:.2e}")
    return err, err_fused


def eigh_blocks(device, seed):
    """[4,19,19] and [256,19,19] blocks as the ``psd_method="eigh"`` slack
    step hands the fused kernel (``gmw=False``): random symmetric blocks
    after the eigenvalue shift (`gradients.psd_repair`), with right-hand
    sides.  [(name, h, b)]."""
    import numpy as np
    import torch
    from trajopt_tpu_torch.ops import gradients as gr

    g = np.random.default_rng(seed)
    out = []
    for n in (SLICE_PIECES[0], FLEET * FLEET_PIECES):
        a = g.normal(size=(n, 19, 19))
        h = gr.psd_repair(torch.as_tensor(a + a.transpose(0, 2, 1), dtype=torch.float32,
                                          device=device))
        out.append((f"eigh-shifted [{n},19,19] b=[{n},19]", h.contiguous(),
                    torch.as_tensor(g.normal(size=(n, 19)), dtype=torch.float32, device=device)))
    return out


def check_pd_solve(device, log):
    """The fused kernel with ``gmw=False`` (the ``eigh`` slack step: a plain
    Cholesky factor and solve of shifted, positive-definite blocks) against
    `factor_solve_plain(gmw=False)` at [4,19,19] and [256,19,19]: no boost,
    x within 1e-3 relative of plain's or its residual on h within twice
    plain's (and 1e-5), and ``want_l=False`` the same x bit for bit.
    Returns the largest abs error."""
    import torch
    from trajopt_tpu_torch.ops import cuda_chol
    from trajopt_tpu_torch.testing import EDGE_SEED

    err = 0.0
    for name, h, b in eigh_blocks(device, EDGE_SEED + 6):
        l, e, x = cuda_chol.factor_solve(h, b, gmw=False)
        none, e2, x2 = cuda_chol.factor_solve(h, b, gmw=False, want_l=False)
        _sync(device)
        pl, pe, px = cuda_chol.factor_solve_plain(h, b, gmw=False)
        check(bool((e == 0).all()) and bool((pe == 0).all()), f"fused gmw=False {name}: a boost")
        check(none is None and torch.equal(x2, x), f"fused gmw=False {name}: want_l=False changes x")
        check(bool(torch.isfinite(x).all()), f"fused gmw=False {name}: x is not finite")
        dx = float((x - px).abs().max() / px.abs().max())
        res, res_plain = (_system_residual(h.double(), v.double(), b.double()) for v in (x, px))
        check(dx <= 1e-3 or res <= max(1e-5, 2.0 * res_plain),
              f"fused gmw=False {name}: x differs from plain by {dx:.3g} relative, residual "
              f"{res:.3g} (plain {res_plain:.3g})")
        dl = float((l - pl).abs().max() / pl.abs().max())
        check(dl <= 1e-4, f"fused gmw=False {name}: L differs from plain by {dl:.3g} relative")
        err = max(err, float((x - px).abs().max()), float((l - pl).abs().max()))
        log(f"  fused factor_solve gmw=False {name}: x vs plain {dx:.2e}, L vs plain {dl:.2e}, "
            f"residual {res:.2e} (plain {res_plain:.2e})")
    return err


SLACK_TOL = 1e-4   # slack_step's values: |a - b| <= SLACK_TOL (1 + |b|); the plain
                   # version's own float32 against its float64 reads 1.5e-5 at most
                   # on testing.SLACK_CASES (on the CPU)
SLACK_ROUNDING = 1e-5   # an Armijo decision within float32 rounding: the step's energy
                        # change within this x (1 + |e0|) of 0


def check_slack_case(case, device, log=None):
    """`slack_step` on one of `testing.SLACK_CASES` (float32, on the card)
    against the plain version on the same inputs on the card, and both
    against the plain version in float64 on the CPU (where the edge is not
    float32's own): one launch; the accepted rung of every piece equal, or
    one apart where the step's float64 energy change is within float32
    rounding (`SLACK_ROUNDING`); slacks, duals and residuals within
    `SLACK_TOL` and non-finite in the same places; the edge's own outcome
    (the floor rung; the clamped time).  Returns the largest abs error
    against the float32 plain version."""
    import torch
    from trajopt_tpu_torch import testing
    from trajopt_tpu_torch.ops import _cuda, cuda_slack
    from trajopt_tpu_torch.ops import energies as en
    from trajopt_tpu_torch.solver import admm

    name, robots, pieces, ks, edge = case
    consts64, cfg, state64 = testing.slack_case(robots, pieces, ks, edge)
    on_card = lambda x: type(x)(*(t.to(device=device, dtype=torch.float32)
                                  if t.is_floating_point() else t.to(device) for t in x))
    consts, state = on_card(consts64), on_card(state64)
    before = _cuda.LAUNCHES["slack_step"]
    got, res, rungs = cuda_slack.slack_step(consts, cfg, state)
    _sync(device)
    check(_cuda.LAUNCHES["slack_step"] == before + 1, f"slack {name}: not one launch")
    plain, plain_res, plain_rungs = testing.slack_with_rungs(admm.slack_update_plain, consts,
                                                             cfg, state)
    fields = ("p_slack", "t_slack", "p_lambda", "t_lambda")
    e0 = en.slack_energy(consts64, cfg, *_slack_energy_args(consts64, state64, state64))

    def rung_faults(have, want, ref_state):
        k, w = have.cpu().long().flatten(), want.cpu().long().flatten()
        off = torch.nonzero(k != w).flatten()
        e1 = en.slack_energy(consts64, cfg, *_slack_energy_args(consts64, state64, ref_state))
        close = (e1 - e0).abs().flatten() <= SLACK_ROUNDING * (1 + e0.abs().flatten())
        return [int(i) for i in off if (k[i] - w[i]).abs() != 1 or not bool(close[i])], len(off)

    def hold(label, ref, ref_res, ref_rungs, other=got, other_res=res, other_rungs=rungs):
        faults, n_off = rung_faults(other_rungs, ref_rungs, ref)
        check(not faults, f"slack {name}: rungs {faults[:8]} differ from {label} by more than "
                          f"float32 rounding allows")
        worst = 0.0
        for f, a, b in [(f, getattr(other, f), getattr(ref, f)) for f in fields] + [
                ("residual", other_res, ref_res)]:
            a, b = a.double().cpu(), b.double().cpu()
            try:   # |a - b| <= SLACK_TOL (1 + |b|), NaN and +-inf in the same places
                torch.testing.assert_close(a, b, rtol=SLACK_TOL, atol=SLACK_TOL, equal_nan=True)
            except AssertionError as e:
                raise CheckFailed(f"slack {name}: {f} against {label}: {e}") from None
            fin = torch.isfinite(b)
            worst = max(worst, float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0)
        return worst, n_off

    err, off32 = hold("plain float32", plain, plain_res, plain_rungs)
    line = f"  slack_step {name}: vs plain float32 {err:.3g} abs, {off32} rungs one apart"
    if edge not in testing.SLACK_F32_ONLY:
        ref, ref_res, ref_rungs = testing.slack_with_rungs(admm.slack_update_plain, consts64,
                                                           cfg, state64)
        err64, off64 = hold("plain float64", ref, ref_res, ref_rungs)
        hold("plain float64 (the plain version's float32)", ref, ref_res, ref_rungs,
             other=plain, other_res=plain_res, other_rungs=plain_rungs)
        line += f"; vs plain float64 {err64:.3g} abs, {off64} rungs one apart"
    r, q = (min(testing.SLACK_EDGE_AT[0], robots - 1), min(testing.SLACK_EDGE_AT[1], pieces - 1))
    at = (r, q) if robots > 1 else (q,)
    if edge in ("nan", "overflow"):
        check(int(rungs[at]) == cfg.max_line_search - 1, f"slack {name}: the floor rung was not taken")
    if edge == "clamp":
        ratio = float(got.t_slack[at] / state.t_slack[at])
        want = 1 - 0.95 * 0.8 ** int(rungs[at])
        check(abs(ratio - want) <= 1e-5, f"slack {name}: t fell to {ratio:.6g} of itself, "
                                         f"not {want:.6g} (the clamp)")
    if log is not None:
        log(line + f"; rungs {int(rungs.sum())} in {rungs.numel()} pieces")
    return err


def _slack_energy_args(consts, state0, state):
    """`energies.slack_energy`'s arguments after ``consts, cfg`` for the
    slacks of ``state`` against the spline and duals of ``state0``
    (float64, on the CPU)."""
    import torch
    from trajopt_tpu_torch.ops import energies as en

    n = state0.t_slack.numel()
    lead = state0.spline.shape[:-2]
    c = torch.einsum("pij,...pjd->...pid", consts.convert.double(),
                     en.piece_cps(consts, state0.spline.double().cpu())).reshape(n, -1, 3)
    t = torch.broadcast_to(state0.piece_time.double().cpu()[..., None],
                           lead + (consts.piece_num,)).reshape(n)
    flat = lambda x: x.double().cpu().reshape((n,) + x.shape[len(lead) + 1:])
    return (c, t, flat(state.p_slack), flat(state.t_slack), flat(state0.p_lambda),
            flat(state0.t_lambda))


def check_slack_step(device, log):
    """`check_slack_case` on every case of `testing.SLACK_CASES`; the
    largest abs error against the float32 plain version."""
    from trajopt_tpu_torch import testing

    return max(check_slack_case(case, device, log) for case in testing.SLACK_CASES)


EIG_TOL = 1e-5       # K6 against float64: |w - w64| <= EIG_TOL x |H|_F, block by block
LADDER_MARGIN = 1e-3  # a ladder trial whose float64 least eigenvalue is this far
                      # (x |H|_F) from 0 has one PD verdict any float32 Cholesky must give


PSD_KERNELS = (("cuda_eig", "eigvalsh"), ("cuda_chol", "mod_chol"), ("cuda_chol", "chol_solve"),
               ("cuda_chol", "factor_solve"))


@functools.lru_cache(maxsize=None)
def psd_call_inputs(device):
    """The inputs that phase 8's paths hand K6, K3, K4 and the fused launch
    (`step_call_inputs`): from the start of each of its solves with each
    method (`psd_cases`: the bridge at P=4 and the 64-robot cross coupled),
    of its batch of 16 and of phase 7's batch of 1024 (K6's and the
    ladder's largest shapes).  The ladder's calls of K3 are its PD test
    (``gmw=False``) on the trials of every rung ([N*14,19,19]) and of each
    bisection step ([N,19,19]); made once a run."""
    from trajopt_tpu_torch.solver import driver

    problems = []
    for case in psd_cases():
        cfg, _, _, consts, scene, state = case.build(device)
        problems.append((case.label.removeprefix("phase 8 "),
                         driver.fused_step(consts, cfg, scene, case.coupled), (state,)))
    for method in PSD_METHODS:
        for b in (PSD_BATCH, BATCH_SIZES[-1]):
            cfg, _, _, consts, scene, states = build_batch(b, device)
            step = driver.fused_step(consts, cfg.replace(psd_method=method), scene, False,
                                     interact=False)
            problems.append((f"batch{b} single {method}", step, (states,)))
    out = step_call_inputs(problems, PSD_KERNELS, "phase 8")
    _sync(device)
    return out


def ladder_trials(calls):
    """(label, trials) of each PD test of the shift ladder among ``calls``
    (`step_call_inputs`): K3's calls with ``gmw=False``."""
    return [(name, args[0]) for name, args, kw in calls["mod_chol"] if kw.get("gmw") is False]


def check_eig(device, log, calls):
    """K6 (`cuda_eig.eigvalsh`) against the float64 eigenvalues of the same
    float32 blocks (`torch.linalg.eigvalsh`, its plain version, on the CPU;
    it reads the lower triangle, as K6 does), on the solver's own blocks
    (``calls``, from `step_call_inputs`) and the edge blocks
    (`testing.eig_edge_blocks`):
    every eigenvalue within EIG_TOL x |H|_F of its block's, ascending, and
    NaN throughout for a block with a non-finite entry.  Logs the float32
    `torch.linalg.eigvalsh` on the card (finite blocks) beside it.  Returns
    the largest abs error."""
    import numpy as np
    import torch
    from trajopt_tpu_torch.ops import cuda_eig
    from trajopt_tpu_torch.testing import EDGE_SEED, eig_edge_blocks

    t = _f32(device)
    cases = [(name, args[0]) for name, args, _ in calls["eigvalsh"]] + [
        (name, t(h)) for name, h in eig_edge_blocks(np.random.default_rng(EDGE_SEED + 8))]
    err = worst_all = 0.0
    for name, h in cases:
        m = h.shape[-1]
        w = cuda_eig.eigvalsh(h)
        _sync(device)
        flat, wf = h.reshape(-1, m, m), w.reshape(-1, m)
        finite = torch.isfinite(flat).all(-1).all(-1)
        check(bool(wf[~finite].isnan().all()), f"K6 {name}: a block with a non-finite entry "
                                               "gives a number")
        hd = flat[finite].double().cpu()
        ref = torch.linalg.eigvalsh(hd)
        scale = torch.linalg.matrix_norm(hd).clamp(min=1e-30)
        got = wf[finite].double().cpu()
        check(bool(torch.isfinite(got).all()), f"K6 {name}: a finite block gives a non-finite value")
        check(bool((got.diff(dim=-1) >= 0).all()), f"K6 {name}: eigenvalues not ascending")
        worst = float(((got - ref).abs().amax(-1) / scale).max())
        check(worst <= EIG_TOL, f"K6 {name}: |w - w64| / |H|_F = {worst:.3g} (bound {EIG_TOL:g})")
        lib = torch.linalg.eigvalsh(flat[finite]).double().cpu()
        lib_dist = float(((lib - ref).abs().amax(-1) / scale).max())
        from_lib = float(((got - lib).abs().amax(-1) / scale).max())
        err = max(err, float((got - ref).abs().max()))
        worst_all = max(worst_all, worst)
        log(f"  K6 eigvalsh {name}: max |w - w64| / |H|_F {worst:.2e} (bound {EIG_TOL:g}); float32 "
            f"torch.linalg.eigvalsh on the card {lib_dist:.2e}, K6 from it {from_lib:.2e}; "
            f"{int((~finite).sum())} non-finite blocks, all NaN")
    log(f"  K6 eigvalsh: worst |w - w64| / |H|_F over every case {worst_all:.2e} (the first "
        "version's, one warp a block: 3.6e-7)")
    return err


def check_ladder_trials(device, log, calls):
    """K3's plain mode (``gmw=False``, what the shift ladder's PD test
    launches) on the ladder's own trials (`ladder_trials` of ``calls``: every
    rung's and every bisection step's; the solver's start blocks are
    positive definite, so the trials of 256 random
    indefinite blocks are added, where rungs fail and pass): the verdict
    the ladder reads (a finite, positive diagonal) against the float64
    spectrum, which decides it where the least eigenvalue is more than
    LADDER_MARGIN x |H|_F from 0 (a float32 Cholesky succeeds above that
    and fails below it); the plain version on the same trials beside it.
    Logs how many trials each gets wrong there and how many lie within the
    margin; both must get none wrong."""
    import numpy as np
    import torch
    from trajopt_tpu_torch.ops import cuda_chol
    from trajopt_tpu_torch.ops import gradients as gr
    from trajopt_tpu_torch.testing import EDGE_SEED

    def verdict(l):
        d = torch.diagonal(l, dim1=-2, dim2=-1)
        return torch.all(torch.isfinite(d) & (d > 0), dim=-1).cpu()

    a = np.random.default_rng(EDGE_SEED + 9).normal(size=(FLEET * FLEET_PIECES, 19, 19))
    sym = _f32(device)((a + a.transpose(0, 2, 1)) * 10.0)
    trial = recorded_calls(cuda_chol, "mod_chol", lambda: gr.psd_repair_ladder(sym))[0][0]
    cases = ladder_trials(calls) + [
        (f"ladder trials of random indefinite {_dims((sym,))}: {_dims((trial,))}", trial)]
    for name, h in cases:
        kern = verdict(cuda_chol.mod_chol(h, gmw=False)[0])
        plain = verdict(cuda_chol.mod_chol_plain(h, gmw=False)[0])
        hd = h.double().cpu()
        least = torch.linalg.eigvalsh(hd)[..., 0] / torch.linalg.matrix_norm(hd).clamp(min=1e-30)
        pd, indefinite = least > LADDER_MARGIN, least < -LADDER_MARGIN
        clear = pd | indefinite
        wrong = int((kern[clear] != pd[clear]).sum())
        wrong_plain = int((plain[clear] != pd[clear]).sum())
        log(f"  K3 mod_chol gmw=False {name}: {int(kern.sum())} PD verdicts of {kern.numel()} "
            f"(plain {int(plain.sum())}, kernel and plain differ on {int((kern != plain).sum())}); "
            f"against float64 wrong on {wrong} (plain {wrong_plain}) of {int(clear.sum())}, "
            f"{int((~clear).sum())} within the margin")
        check(wrong == 0, f"K3 gmw=False {name}: {wrong} PD verdicts against the float64 spectrum")
        check(wrong_plain == 0, f"K3 plain {name}: {wrong_plain} PD verdicts against float64")


COND_CASES = ("if", "if_else", "while", "nested")


def _counting_nodes():
    from trajopt_tpu_torch.runtime import graph

    class CountingNodes(graph.EagerNodes):
        """The nodes' CPU stand-in, counting the conditions it reads
        (``per_if`` for each IF/ELSE)."""

        def __init__(self, per_if):
            self.per_if, self.reads = per_if, 0

        def cond(self, pred, then, orelse):
            self.reads += self.per_if
            super().cond(pred, then, orelse)

        def loop(self, cond, body):
            def counted():
                self.reads += 1
                return cond()

            super().loop(counted, body)

    return CountingNodes


def cond_probe(device, log, cases=COND_CASES):
    """``set_condition`` and the conditional nodes it drives against their
    plain version, the host branch (`runtime.graph`'s branch form on the
    same inputs), in float32 on the card.  Each case is captured once in
    the conditional form (`graph.capture_fn`) and launched at each of its
    inputs, which the host writes into the graph's input buffers: "if"
    two IF nodes of one body each (the form before CUDA 12.8), "if_else"
    an IF node with an ELSE body, each with the predicate true and false
    and sides that return an operand, a view of one and new tensors;
    "while" a WHILE that counts to its 10-round bound, one its predicate
    stops early and one of 0 trips; "nested" a WHILE in a WHILE with an IF
    in each inner round (three levels of bodies, as the decoupled solve
    nests them).  Every output equals the branch form's bit for bit, and
    each launch's ``set_condition`` executions (its tallies) equal the
    conditions the branch form read.  Returns the largest abs difference."""
    import torch
    from trajopt_tpu_torch.ops import cuda_cond
    from trajopt_tpu_torch.runtime import graph, trace

    f32 = dict(device=device, dtype=torch.float32)
    CountingNodes = _counting_nodes()
    runtime, driver = cuda_cond.versions()
    log(f"  conditional nodes: CUDA runtime {runtime}, driver {driver}; IF/ELSE nodes "
        f"{'available' if cuda_cond.if_else_nodes() else 'not available (two IF nodes instead)'}")
    zero = lambda like: torch.zeros((), dtype=torch.int64, device=like.device)

    def if_fn(p, x, limit):
        return graph.device_cond(p, lambda a: (a, a[1:], a.sum() * 2.0),
                                 lambda a: (a * 3.0 - 1.0, a[:3] + limit, a.amax()), x)

    def while_fn(p, x, limit):
        return graph.fixed_rounds(10, lambda v, n: v.sum() < limit, lambda v, n: (v + 1.0, n + 1),
                                  x, zero(x))

    def nested_fn(p, x, limit):
        def rounds(i, v):
            def inner(j, w):
                w = graph.device_cond((j % 2) == 0, lambda: w + j.to(w.dtype), lambda: w * 1.5)
                return j + 1, w
            j, w = graph.fixed_rounds(5, lambda j, w: w.sum() < limit * 4.0, inner,
                                      zero(v), v)
            return i + 1, w - 1.0
        return graph.fixed_rounds(4, lambda i, v: (v.sum() < limit * 40.0) & p, rounds,
                                  zero(x), x)

    x0 = torch.arange(4, **f32)
    inputs = {      # (p, x, limit) at each launch
        "if": [(True, x0, 0.5), (False, x0, 0.5), (True, -x0, 2.0)],
        "while": [(True, x0, 30.0), (True, x0, 100.0), (True, x0, -1.0)],
        "nested": [(True, x0, 10.0), (True, -x0, 1e4), (False, x0, 1e4), (True, x0, -1.0)],
    }
    inputs["if_else"] = inputs["if"]
    fns = {"if": if_fn, "if_else": if_fn, "while": while_fn, "nested": nested_fn}
    worst = 0.0
    for case in cases:
        t0 = time.perf_counter()
        p = torch.zeros((), dtype=torch.bool, device=device)
        x, limit = torch.zeros(4, **f32), torch.zeros((), **f32)
        with trace.on():
            g, out, run = graph.capture_fn(lambda: fns[case](p, x, limit), device,
                                           if_else=False if case == "if" else None)
        for pv, xv, lv in inputs[case]:
            p.fill_(pv)
            x.copy_(xv)
            limit.fill_(lv)
            g.replay()
            torch.cuda.synchronize()
            want = fns[case](torch.tensor(pv, device=device), xv.clone(),
                             torch.tensor(lv, **f32))
            for a, b in zip(graph._leaves(out), graph._leaves(want)):
                check(a.dtype == b.dtype and a.shape == b.shape, f"{case}: output shape differs")
                same = bool(torch.equal(a, b))
                diff = 0.0 if same else float((a.double() - b.double()).abs().max())
                worst = max(worst, diff)
                check(same, f"{case} at p={pv} limit={lv}: a node's output differs from the host "
                            f"branch's by {diff:.3g}")
            # the conditions the nodes' stand-in reads on the CPU, one
            # set_condition each (two an IF/ELSE in the two-IF form)
            stand_in = CountingNodes(1 if run.versions["if_else"] else 2)
            with graph.conditional_form(stand_in):
                fns[case](torch.tensor(pv), xv.cpu(), torch.tensor(lv, dtype=torch.float32))
            evals = run.set_condition_evaluations()
            check(evals == stand_in.reads, f"{case}: {evals} set_condition executions, the "
                                           f"stand-in read {stand_in.reads} conditions")
        log(f"  {case}: {len(inputs[case])} launches of one capture bit-equal to the host branch; "
            f"nodes {run.cond_nodes}, set_condition kernel nodes "
            f"{run.kernel_nodes['set_condition']}, executions in the last launch {evals} "
            f"({time.perf_counter() - t0:.2f} s)")
        del g
    return worst


def set_condition_timings(device, reps=50):
    """``set_condition`` beside its plain version: ``ms`` one ``device_cond``
    as a node (its ``set_condition`` launch, an IF/ELSE node, one-element
    sides), per node from ``reps`` of them chained in one graph, between
    CUDA events (best of three launches); ``device_ms`` the kernel's own
    time, its mean record under torch.profiler in that graph; ``plain_ms``
    the host read of the predicate per call between CUDA events; beside
    them the same chain in the select form (both sides and a
    ``torch.where`` a link).  Bound: the byte it reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from trajopt_tpu_torch.runtime import graph

    pred = torch.tensor(True, device=device)
    x = torch.zeros(1, device=device, dtype=torch.float32)

    def chain():
        y = x
        for _ in range(reps):
            y = graph.device_cond(pred, lambda a: a + 1.0, lambda a: a - 1.0, y)
        return y

    def per_link(g):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(3):
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / reps)
        return best

    g, y, run = graph.capture_fn(chain, device)
    ms = per_link(g)
    check(float(y) == reps, f"set_condition timing chain: {float(y)}, the host branch gives {reps}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    recs = [e for e in prof.key_averages() if "set_condition" in e.key]
    n = sum(e.count for e in recs)
    busy_us = 0.0
    for e in recs:
        t = getattr(e, "self_device_time_total", None)
        busy_us += e.self_cuda_time_total if t is None else t
    gs, ys, _ = graph.capture_fn(chain, device, form="select")
    select_ms = per_link(gs)
    check(float(ys) == reps, "set_condition timing chain: the select form differs")
    return {"shape": "0-d bool", "ms": ms, "device_ms": busy_us / 1e3 / max(n, 1),
            "records": n, "plain_ms": time_ms(lambda: bool(pred)), "select_ms": select_ms,
            "bound_ms": bound_ms(1, 0)[0], "bound_by": bound_ms(1, 0)[1],
            "library_ms": None, "library_device_ms": None}



def check_kernels(device, log, seed=0, pair_diffs=None):
    """Every kernel against its plain version; returns max abs errors.
    ``pair_diffs``: the 64-robot start's pair differences [N,36,3] (built
    here when not given)."""
    import numpy as np

    if pair_diffs is None:
        pair_diffs = fleet_pair_diffs(device)
    rng = np.random.default_rng(seed)
    t = [time.perf_counter()]

    def lap(what):
        t.append(time.perf_counter())
        log(f"  ({what}: {t[-1] - t[-2]:.1f} s)")

    errs = {"set_condition": cond_probe(device, log)}
    lap("conditional nodes")
    errs["smallest_k"] = check_topk(device, rng, log)
    lap("K1 checks")
    errs["gjk_exact"] = check_gjk(device, rng, pair_diffs, log)
    lap("K2 checks")
    errs["gjk_fw"] = check_fw(device, rng, pair_diffs, log)
    lap("K5 checks")
    errs["mod_chol"], factors = check_chol(device, rng, log)
    lap("K3 checks")
    errs["chol_solve"], errs["factor_solve"] = check_solve(device, rng, factors, log)
    errs["factor_solve"] = max(errs["factor_solve"], check_pd_solve(device, log))
    lap("K4 and fused checks")
    errs["slack_step"] = check_slack_step(device, log)
    lap("slack_step checks")
    batch = check_chol_calls(device, log, batch_call_inputs(device))
    for name, err in zip(("mod_chol", "chol_solve", "factor_solve"), batch):
        errs[name] = max(errs[name], err)
    lap("K3, K4 and fused checks on phase 7's inputs")
    calls = psd_call_inputs(device)
    errs["eigvalsh"] = check_eig(device, log, calls)
    check_ladder_trials(device, log, calls)
    # the rest of phase 8's calls (the fused launch with gmw=False on the
    # repaired slack blocks, the KKT's) as phase 7's are held
    gmw = {**calls, "mod_chol": [c for c in calls["mod_chol"] if c[2].get("gmw") is not False]}
    for name, err in zip(("mod_chol", "chol_solve", "factor_solve"), check_chol_calls(device, log, gmw)):
        errs[name] = max(errs[name], err)
    lap("K6, K3's plain mode on the ladder's trials, K3, K4 and fused checks on phase 8's inputs")
    return errs


# ---------------------------------------------------------------------------
# Phase 3: the single-UAV solve
# ---------------------------------------------------------------------------


def build_problem(pieces, device, dtype, **options):
    """The bridge at P pieces; ``options`` (``optimal_plane``, ``psd_method``)
    go to the config."""
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.config import TrajOptConfig
    from trajopt_tpu_torch.ops import splines as sp
    from trajopt_tpu_torch.scenes import generators as gen

    cfg = TrajOptConfig(ks=1e-8, max_planes=16, max_ccd_candidates=16, **options)
    cloud, wp = gen.bridge_scene(n_points=N_POINTS, seed=0, n_pieces=pieces)
    ops = sp.build_spline_ops(pieces, cfg.res)
    kw = dict(device=device, dtype=dtype)
    return (cfg, ops, cloud, tt.device_consts(ops, **kw), tt.make_scene(cloud, **kw),
            tt.init_state(ops, wp, cfg.init_piece_time, **kw))


def host_solve(problem, coupled, max_iters, checkpointer=None):
    """The host-stepped solve of ``problem`` (`build_problem`'s or
    `build_fleet`'s tuple): `driver.solve` when ``coupled`` is None, else
    `driver.solve_multi`, until gnorm < stop or ``max_iters``.  Returns the
    result row (iterations, quality, timing, the final ``state`` and its
    splines and piece times as numpy; ``last_iter``: the last iteration's
    number, which a resumed solve continues)."""
    from trajopt_tpu_torch.solver import driver

    cfg, ops, cloud, consts, scene, state0 = problem
    t0 = time.perf_counter()
    if coupled is None:
        state, hist = driver.solve(consts, cfg, state0, scene, max_iters=max_iters,
                                   checkpointer=checkpointer)
    else:
        state, hist = driver.solve_multi(consts, cfg, state0, scene, coupled=coupled,
                                         max_iters=max_iters)
    wall = time.perf_counter() - t0
    return {
        "iters": len(hist),
        "gnorm": hist[-1]["gnorm"],
        "converged": len(hist) < max_iters and hist[-1]["gnorm"] < cfg.stop,
        **(single_quality if coupled is None else fleet_quality)(ops, cloud, state),
        "offset": cfg.offset,
        "median_iter_ms": statistics.median(h["wall_ms"] for h in hist),
        "solve_s": wall,
        "last_iter": hist[-1]["iter"],
        "state": state,
    }


def solve_case(pieces, device, dtype, max_iters=MAX_ITERS, checkpointer=None, **options):
    """One bridge solve (`host_solve`); ``options`` go to the config."""
    problem = build_problem(pieces, device, dtype, **options)
    return dict(host_solve(problem, None, max_iters, checkpointer), pieces=pieces)


def single_quality(ops, cloud, state):
    """ccd_time, ccd_len and min curve clearance of a single-UAV state, and
    its spline and piece time as numpy."""
    from trajopt_tpu_torch import metrics as mt

    spline = state.spline.detach().double().cpu().numpy()
    piece_time = float(state.piece_time)
    st = mt.trajectory_stats(ops, spline, piece_time)
    return {"ccd_time": st["ccd_time"], "ccd_len": st["ccd_len"],
            "min_clearance": mt.min_curve_clearance(ops, spline, cloud, piece_time),
            "spline": spline, "piece_time": piece_time}


def reference_row(mode, **key):
    """The C++ reference's row: mode "single" with pieces=P, or "coupled" /
    "decoupled" with uavs=U."""
    with open(os.path.join(HERE, "tools", "ref_baseline", "results.json")) as f:
        for case in json.load(f)["cases"]:
            if case["mode"] == mode and all(case.get(k) == v for k, v in key.items()):
                return case
    raise KeyError(f"no C++ reference row for {mode} {key}")


def check_parity(label, row, ref, log, against="C++"):
    dtime = abs(row["ccd_time"] - ref["ccd_time"]) / ref["ccd_time"]
    dlen = abs(row["ccd_len"] - ref["ccd_len"]) / ref["ccd_len"]
    log(f"  vs {against} {label}: iters {ref['iters']} / {row['iters']}, "
        f"ccd_time {ref['ccd_time']:.4f} / {row['ccd_time']:.4f} ({dtime * 100:.2f}%), "
        f"ccd_len {ref['ccd_len']:.4f} / {row['ccd_len']:.4f} ({dlen * 100:.2f}%), "
        f"min clearance {row['min_clearance']:.4f} (offset {row['offset']})")
    check(row["converged"], f"{label}: did not converge")
    check(dtime <= PARITY_TOL, f"{label}: ccd_time off by {dtime * 100:.2f}%")
    check(dlen <= PARITY_TOL, f"{label}: ccd_len off by {dlen * 100:.2f}%")
    check(row["min_clearance"] >= row["offset"], f"{label}: clearance below offset")


def count_syncs(step, outside=False):
    """Host syncs in one call of ``step()``, by source line of the port;
    with ``outside`` also those this script makes in ``step`` itself."""
    import collections
    import traceback

    import torch

    where = collections.Counter()
    pkg = os.path.join(HERE, "trajopt_tpu_torch")
    mine = os.path.abspath(__file__)

    def ours(f):
        return f.filename.startswith(pkg) or (outside and f.filename == mine and f.name != "record")

    def record(message, *args, **kwargs):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()
            # only what ``step`` called: the frames below this function's own
            top = max(i for i, f in enumerate(stack) if f.name == "count_syncs")
            frames = [f for f in stack[top + 1:] if ours(f)]
            # a device_cond's host read is charged to the line that called it
            while len(frames) > 1 and frames[-1].name in ("device_cond", "fixed_rounds"):
                frames.pop()
            if frames:          # switching the debug mode on warns once itself
                f = frames[-1]
                where[f"{os.path.relpath(f.filename, HERE)}:{f.lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return where


def log_syncs(label, where, log):
    log(f"  host syncs in one {label} iteration: {sum(where.values())}")
    for line, n in sorted(where.items()):
        log(f"    {n:3d}  {line}")


def single_steady_syncs(pieces, device, **options):
    """Host syncs of the second step of a bridge solve (`count_syncs`);
    under ``optimal_plane`` the cached step with the first step's cache."""
    import torch
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.solver import admm

    cfg, ops, cloud, consts, scene, state = build_problem(pieces, device, torch.float32, **options)
    if not cfg.optimal_plane:
        state, _ = admm.admm_step(consts, cfg, state, scene)
        return count_syncs(lambda: admm.admm_step(consts, cfg, state, scene))
    cache = tt.empty_plane_cache(consts.piece_num, consts.res, cfg.max_planes, device=device,
                                 dtype=torch.float32)
    state, _, cache = admm.admm_step_cached(consts, cfg, state, scene, cache)
    return count_syncs(lambda: admm.admm_step_cached(consts, cfg, state, scene, cache))


def log_launches(label, launches, by_shape, log):
    log(f"    launches {launches}")
    log(f"    launches by call shape: {by_shape}")


def single_options_phase(device, card_rows, log):
    """Phase 3's other options on the bridge at P=4, each on the card:
    (a) ``optimal_plane``: converged, iterations within ITER_SLACK of the
    port's CPU float64 run and of the JAX package's CPU float64 row
    (`testing.OPTIMAL_PLANE_JAX_ROWS`), ccd_time and ccd_len within 2% of
    both, clearance >= offset, host syncs per steady iteration <= 4;
    (b) ``psd_method="eigh"`` held to the C++ row as the default solve is;
    (c) checkpoint and resume of the default and the ``optimal_plane``
    solve: 12 iterations with a checkpoint every 5, then a fresh
    `driver.solve` resumed from the last one to convergence, which must end
    at the uninterrupted card run's iteration count (``card_rows``) with
    its spline within 1e-5 x max|spline|.  Returns (launches, launches by
    shape) of the (a) and (b) solves."""
    import tempfile

    import numpy as np
    import torch
    from trajopt_tpu_torch.config import TrajOptConfig
    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.runtime.checkpoint import CheckpointManager
    from trajopt_tpu_torch.testing import OPTIMAL_PLANE_JAX_ROWS

    p = SLICE_PIECES[0]
    f32 = torch.float32
    launches, by_shape = {}, {}
    for label, options in (("optimal_plane", dict(optimal_plane=True)),
                           ("eigh", dict(psd_method="eigh"))):
        _cuda.reset_launches()
        row = solve_case(p, device, f32, **options)
        torch.cuda.synchronize()
        key = f"single p{p} {label}"
        launches[key], by_shape[key] = dict(_cuda.LAUNCHES), shape_counts()
        card_rows[label] = row
        log(f"  p{p} {label}: iters {row['iters']}, gnorm {row['gnorm']:.4g}, ccd_time "
            f"{row['ccd_time']:.4f}, ccd_len {row['ccd_len']:.4f}, min clearance "
            f"{row['min_clearance']:.4f}, median {row['median_iter_ms']:.2f} ms/iter, "
            f"solve {row['solve_s']:.2f} s")
        log_launches(key, launches[key], by_shape[key], log)
        check_path_launches(key, launches[key], *path_kernels(TrajOptConfig(**options), None, p))
        if label == "eigh":
            check_parity(key, row, reference_row("single", pieces=p), log)
            log_syncs(f"steady p{p} eigh (the second from the start)",
                      single_steady_syncs(p, device, **options), log)
            continue
        cpu = solve_case(p, torch.device("cpu"), torch.float64, **options)
        jax_row = OPTIMAL_PLANE_JAX_ROWS[f"single p{p}"]
        for against, ref in (("the port's CPU float64", cpu), ("JAX CPU float64", jax_row)):
            gap = abs(row["iters"] - ref["iters"])
            check(gap <= ITER_SLACK, f"{key}: iterations differ from {against} by {gap}")
            check(ref["converged"], f"{key}: {against} did not converge")
            check_parity(key, row, ref, log, against=against)
        syncs = single_steady_syncs(p, device, **options)
        log_syncs(f"steady p{p} {label}", syncs, log)
        check(sum(syncs.values()) <= 4, f"{key}: {sum(syncs.values())} host syncs per steady "
                                        "iteration (the default path makes 4)")
    for label, options in (("default", {}), ("optimal_plane", dict(optimal_plane=True))):
        ref = card_rows[label]
        with tempfile.TemporaryDirectory(dir=HERE) as d:
            first = solve_case(p, device, f32, max_iters=12, checkpointer=CheckpointManager(d, every=5),
                               **options)
            saved = sorted(os.listdir(d))
            resumed = solve_case(p, device, f32, checkpointer=CheckpointManager(d, every=5), **options)
        total = resumed["last_iter"] + 1
        diff = float(np.abs(resumed["spline"] - ref["spline"]).max())
        scale = float(np.abs(ref["spline"]).max())
        log(f"  p{p} {label} checkpoint and resume: {first['iters']} iterations, checkpoints "
            f"{saved}, resumed at {total - resumed['iters']} and ran {resumed['iters']} more to "
            f"{total} (uninterrupted {ref['iters']}), max |spline - uninterrupted| {diff:.3g} "
            f"({diff / scale:.2e} x max|spline|)")
        check(resumed["converged"], f"p{p} {label}: the resumed solve did not converge")
        check(total == ref["iters"], f"p{p} {label}: resumed to {total} iterations, "
                                     f"uninterrupted {ref['iters']}")
        check(diff <= 1e-5 * scale, f"p{p} {label}: the resumed spline is {diff:.3g} off")
    return launches, by_shape


# ---------------------------------------------------------------------------
# Phase 4: the multi-robot solve
# ---------------------------------------------------------------------------


def build_fleet(uavs, device, dtype, **options):
    """The north-star cross (__graft_entry__.py's problem as bench.py calls
    it): cross scene of 4000 points, lane-assigned antipodal waypoints,
    4 pieces, res 8; ``options`` go to the config."""
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.config import TrajOptConfig
    from trajopt_tpu_torch.ops import splines as sp
    from trajopt_tpu_torch.scenes import generators as gen
    from trajopt_tpu_torch.solver import multi

    cfg = TrajOptConfig(res=8, ks=1e-3, max_planes=16, max_self_planes=4, max_ccd_candidates=16,
                        **options)
    cloud = gen.cross_scene(n_points=FLEET_POINTS, seed=0)
    wps = gen.assign_lanes(gen.cross_waypoints(uavs, FLEET_PIECES), cloud)
    ops = sp.build_spline_ops(FLEET_PIECES, cfg.res)
    kw = dict(device=device, dtype=dtype)
    return (cfg, ops, cloud, tt.device_consts(ops, **kw), tt.make_scene(cloud, **kw),
            multi.init_multi_state(ops, wps, cfg.init_piece_time, **kw))


def fleet_pair_diffs(device):
    """[pairs*P*R, 36, 3] Minkowski differences of the 64-robot start's
    equal-segment hull pairs (float32, on ``device``)."""
    import torch
    from trajopt_tpu_torch.ops import geometry as geo
    from trajopt_tpu_torch.solver import driver

    _, _, _, consts, _, state = build_fleet(FLEET, device, torch.float32)
    return geo.minkowski_diff(*driver.robot_pair_hulls(consts, state.spline)).contiguous()


def solve_fleet(uavs, coupled, device, dtype, **options):
    """One cross solve (`host_solve`); returns (row, cfg, consts, scene,
    final state)."""
    cfg, ops, cloud, consts, scene, state0 = problem = build_fleet(uavs, device, dtype, **options)
    row = dict(host_solve(problem, coupled, FLEET_MAX_ITERS), uavs=uavs,
               mode="coupled" if coupled else "decoupled")
    return row, cfg, consts, scene, row["state"]


def fleet_quality(ops, cloud, state):
    """ccd_time and ccd_len summed over the robots, the min curve clearance,
    and the splines and piece times as numpy."""
    from trajopt_tpu_torch import metrics as mt

    splines = state.spline.detach().double().cpu().numpy()
    times = state.piece_time.detach().double().cpu().numpy()
    ccd_time = ccd_len = 0.0
    clearance = float("inf")
    for i in range(splines.shape[0]):
        st = mt.trajectory_stats(ops, splines[i], float(times[i]))
        ccd_time += st["ccd_time"]
        ccd_len += st["ccd_len"]
        clearance = min(clearance, float(mt.min_curve_clearance(ops, splines[i], cloud,
                                                                float(times[i]))))
    return {"ccd_time": ccd_time, "ccd_len": ccd_len, "min_clearance": clearance,
            "spline": splines, "piece_time": times}


def pair_clearance_check(cfg, consts, state, log):
    """Min pairwise hull clearance of the final fleet at equal segment index
    by K2 (`driver.initial_pair_clearance`), cross-checked pair by pair by
    K5 (Frank-Wolfe, 32 rounds, `gjk_pairs`) on the same hull pairs: K5's
    certified lb may not exceed K2's distance (`driver.pair_hull_dist`), nor
    its dist fall below it, by more than 1e-5 on the pairs within 1 m, the
    ones the clearance guarantee is about.  Pairs farther apart span tens of
    metres, where K2's own stop test (|v|^2 within 100 float32 epsilons)
    leaves up to ~7e-6 x max|u| (PERF.md): there the bound is 1e-5 x max|u|."""
    import torch
    from trajopt_tpu_torch.ops import cuda_gjk
    from trajopt_tpu_torch.ops import geometry as geo
    from trajopt_tpu_torch.solver import driver

    clr = driver.initial_pair_clearance(consts, state)
    k2 = driver.pair_hull_dist(consts, state.spline)
    a, b = driver.robot_pair_hulls(consts, state.spline)
    fw = cuda_gjk.gjk_pairs(a.contiguous(), b.contiguous(), 32)
    near = k2.dist < 1.0
    scale = geo.minkowski_diff(a, b).abs().amax(dim=(1, 2))
    tol = torch.where(near, 1e-5, 1e-5 * scale)
    over, under = fw.lb - k2.dist, k2.dist - fw.dist
    top = lambda x: float(x.max()) if x.numel() else float("-inf")
    log(f"  pairwise clearance (K2, {a.shape[0]} hull pairs): {clr:.5f} (offset {cfg.offset}); "
        f"K5: min dist {float(fw.dist.min()):.5f}; on the {int(near.sum())} pairs within 1 m "
        f"max (lb - K2 dist) {top(over[near]):.2e}, max (K2 dist - dist) {top(under[near]):.2e}; "
        f"elsewhere the same over max|u| {top((over / scale)[~near]):.2e}, "
        f"{top((under / scale)[~near]):.2e}")
    check(clr >= cfg.offset - 1e-6, f"pairwise clearance {clr:.6f} below offset {cfg.offset}")
    check(bool((over <= tol).all()), f"K5 lb exceeds K2's distance by {float(over.max()):.3g}")
    check(bool((under <= tol).all()), f"K5 dist falls below K2's distance by {float(under.max()):.3g}")
    return clr


def device_busy_share(step, reps=3):
    """(device busy ms, wall ms) over ``reps`` calls of ``step()`` under
    torch.profiler; busy is the sum of the CUDA kernels' self times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            busy_us += evt.self_cuda_time_total if t is None else t
    return busy_us / 1e3, wall_ms


def fleet_phase(device, log):
    """Phase 4; returns the launch counts of each path and the rows."""
    import torch
    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.solver import multi

    launches, rows, by_shape = {}, {}, {}
    for coupled in (True, False):
        mode = "coupled" if coupled else "decoupled"
        _cuda.reset_launches()
        row, cfg, consts, scene, state = solve_fleet(FLEET, coupled, device, torch.float32)
        torch.cuda.synchronize()
        launches[f"u{FLEET} {mode}"] = dict(_cuda.LAUNCHES)
        by_shape[f"u{FLEET} {mode}"] = shape_counts()
        rows[mode] = row
        log(f"  u{FLEET} {mode}: iters {row['iters']} (C++ {reference_row(mode, uavs=FLEET)['iters']}), "
            f"gnorm {row['gnorm']:.4g}, median {row['median_iter_ms']:.2f} ms/iter, "
            f"solve {row['solve_s']:.2f} s, launches {launches[f'u{FLEET} {mode}']}")
        log(f"    launches by call shape: {by_shape[f'u{FLEET} {mode}']}")
        check_path_launches(f"u{FLEET} {mode}", launches[f"u{FLEET} {mode}"],
                            *path_kernels(cfg, coupled, FLEET_PIECES))
        check_parity(f"u{FLEET} {mode}", row, reference_row(mode, uavs=FLEET), log)
        _cuda.reset_launches()
        row["pair_clearance"] = pair_clearance_check(cfg, consts, state, log)
        torch.cuda.synchronize()
        launches[f"u{FLEET} {mode} pair clearance"] = dict(_cuda.LAUNCHES)
        check(_cuda.LAUNCHES["gjk_fw"] > 0, "K5 was never launched by the clearance cross-check")

        # steady-state cost of one iteration from the converged-regime start
        # of this solve's last iterate
        step = lambda: multi.multi_admm_step(consts, cfg, state, scene, coupled)
        step()
        log_syncs(f"steady u{FLEET} {mode}", count_syncs(step), log)
        busy, wall = device_busy_share(step)
        row["busy_ms"], row["profiled_wall_ms"] = busy / 3, wall / 3
        log(f"  torch.profiler, 3 steady u{FLEET} {mode} iterations: device busy {busy / 3:.3f} ms "
            f"per iteration of {wall / 3:.3f} ms wall, idle share "
            f"{1.0 - busy / wall if wall > 0 else float('nan'):.3f}")

    # the port's card float32 against its own CPU float64 run
    small, _, _, _, _ = solve_fleet(SMALL_FLEET, True, device, torch.float32)
    cpu, _, _, _, _ = solve_fleet(SMALL_FLEET, True, torch.device("cpu"), torch.float64)
    ref = reference_row("coupled", uavs=SMALL_FLEET)
    log(f"  u{SMALL_FLEET} coupled: card float32 iters {small['iters']}, CPU float64 iters "
        f"{cpu['iters']}, C++ {ref['iters']}")
    check(abs(small["iters"] - cpu["iters"]) <= ITER_SLACK,
          f"u{SMALL_FLEET}: card and CPU float64 iteration counts differ by "
          f"{abs(small['iters'] - cpu['iters'])}")
    check_parity(f"u{SMALL_FLEET} coupled card", small, ref, log)
    check_parity(f"u{SMALL_FLEET} coupled CPU float64", cpu, ref, log)
    return launches, rows, by_shape


def optimal_fleet_phase(device, log):
    """Phase 4's ``optimal_plane`` solves: the 64-robot cross coupled at full
    width (every robot's full obstacle table, U*P*R*K = 32768 K2 slots an
    iteration) held to the JAX package's CPU float64 row
    (`testing.OPTIMAL_PLANE_JAX_ROWS`: converged, iterations within
    ITER_SLACK, ccd within 2%), obstacle clearance >= offset, pairwise
    clearance by K2 cross-checked by K5, launches of K1-K4 and the fused
    kernel (also by call shape), host syncs per steady iteration (<= 9, the
    default path's count) and the device's idle share; then 4 robots coupled
    on the card against the port's CPU float64 run.  Returns (launches,
    launches by shape, the 64-robot row)."""
    import torch
    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.solver import multi
    from trajopt_tpu_torch.testing import OPTIMAL_PLANE_JAX_ROWS

    opt = dict(optimal_plane=True)
    key = f"u{FLEET} coupled optimal_plane"
    _cuda.reset_launches()
    row, cfg, consts, scene, state = solve_fleet(FLEET, True, device, torch.float32, **opt)
    torch.cuda.synchronize()
    launches, by_shape = {key: dict(_cuda.LAUNCHES)}, {key: shape_counts()}
    jax_row = OPTIMAL_PLANE_JAX_ROWS[f"u{FLEET} coupled"]
    log(f"  {key}: iters {row['iters']} (JAX CPU float64 {jax_row['iters']}, C++ with "
        f"optimal_plane=0 {reference_row('coupled', uavs=FLEET)['iters']}), gnorm {row['gnorm']:.4g}, "
        f"median {row['median_iter_ms']:.2f} ms/iter, solve {row['solve_s']:.2f} s")
    log_launches(key, launches[key], by_shape[key], log)
    check_path_launches(key, launches[key], *path_kernels(cfg, True, FLEET_PIECES))
    check(jax_row["converged"], f"{key}: the JAX row did not converge")
    gap = abs(row["iters"] - jax_row["iters"])
    check(gap <= ITER_SLACK, f"{key}: iterations differ from JAX CPU float64 by {gap}")
    check_parity(key, row, jax_row, log, against="JAX CPU float64")
    _cuda.reset_launches()
    pair_clearance_check(cfg, consts, state, log)
    torch.cuda.synchronize()
    launches[f"{key} pair clearance"] = dict(_cuda.LAUNCHES)
    check(_cuda.LAUNCHES["gjk_fw"] > 0, "K5 was never launched by the clearance cross-check")

    caches = multi.init_multi_caches(cfg, consts, FLEET, device=device, dtype=torch.float32)
    state1, _, caches = multi.multi_admm_step_cached(consts, cfg, state, scene, True, caches)
    step = lambda: multi.multi_admm_step_cached(consts, cfg, state1, scene, True, caches)
    step()
    syncs = count_syncs(step)
    log_syncs(f"steady {key}", syncs, log)
    check(sum(syncs.values()) <= 9, f"{key}: {sum(syncs.values())} host syncs per steady "
                                    "iteration (the default coupled path makes 9)")
    busy, wall = device_busy_share(step)
    log(f"  torch.profiler, 3 steady {key} iterations: device busy {busy / 3:.3f} ms per "
        f"iteration of {wall / 3:.3f} ms wall, idle share "
        f"{1.0 - busy / wall if wall > 0 else float('nan'):.3f}")

    small, _, _, _, _ = solve_fleet(SMALL_FLEET, True, device, torch.float32, **opt)
    cpu, _, _, _, _ = solve_fleet(SMALL_FLEET, True, torch.device("cpu"), torch.float64, **opt)
    log(f"  u{SMALL_FLEET} coupled optimal_plane: card float32 iters {small['iters']}, CPU float64 "
        f"iters {cpu['iters']}")
    check(abs(small["iters"] - cpu["iters"]) <= ITER_SLACK,
          f"u{SMALL_FLEET} optimal_plane: card and CPU float64 iteration counts differ by "
          f"{abs(small['iters'] - cpu['iters'])}")
    check(cpu["converged"], f"u{SMALL_FLEET} optimal_plane: the CPU float64 run did not converge")
    check_parity(f"u{SMALL_FLEET} coupled optimal_plane card", small, cpu, log,
                 against="the port's CPU float64")
    return launches, by_shape, row


# ---------------------------------------------------------------------------
# Phase 6: the fused drivers
# ---------------------------------------------------------------------------


# a solve of phases 6 and 8: its label, the function building its problem
# on a device (`build_problem` or `build_fleet` with its config options),
# ``coupled`` (None for one UAV), its C++ row's key (mode, key) and the JAX
# package's CPU float64 row it is held to instead, where it has one
SolveCase = collections.namedtuple("SolveCase", "label build coupled cpp jax")


def fused_cases():
    """Phase 6's solves (`SolveCase`), in the order of the host-stepped ones
    of phases 3-4 they are held to."""
    import torch
    from trajopt_tpu_torch.testing import OPTIMAL_PLANE_JAX_ROWS

    f32 = torch.float32
    return [
        SolveCase(f"single p{p}", lambda d, p=p: build_problem(p, d, f32), None,
                  ("single", dict(pieces=p)), None) for p in SLICE_PIECES
    ] + [
        SolveCase(f"u{FLEET} {mode}", lambda d: build_fleet(FLEET, d, f32), mode == "coupled",
                  (mode, dict(uavs=FLEET)), None) for mode in ("coupled", "decoupled")
    ] + [
        SolveCase(f"u{FLEET} coupled optimal_plane",
                  lambda d: build_fleet(FLEET, d, f32, optimal_plane=True), True,
                  ("coupled", dict(uavs=FLEET)), OPTIMAL_PLANE_JAX_ROWS[f"u{FLEET} coupled"]),
    ]


def path_kernels(cfg, coupled, pieces, fused=False):
    """(the kernels a solve with ``cfg`` must launch, those it must not);
    ``fused``: a fused solve in the conditional form, which launches
    ``set_condition`` (a host-stepped solve must not).
    Past ns = 9P - 3 = 64 a single UAV's reduced KKT is block-tridiagonal
    (K3 in plain mode on its 18 x 18 blocks, `solve_triangular` solves),
    with no launch of `chol_solve`.  ``psd_method="eigh"`` shifts by K6's
    eigenvalues where the GMW repair launches K3, its only caller below
    that size; only "eigh" launches K6 (the ladder's PD test is K3's plain
    mode).  Under "gmw" with the closed-form Hessian the slack phase is one
    `slack_step` launch, so a block-tridiagonal solve launches no fused K3
    + K4; with any other repair (or ``grad_mode="autodiff"``) it is the
    plain version's fused launch and `slack_step` is not launched."""
    tridiagonal = coupled is None and 9 * pieces - 3 > 64
    on = [k for k in SOLVE_KERNELS if k != "chol_solve" or not tridiagonal]
    off = []
    if cfg.psd_method != "eigh":
        off = ["eigvalsh"]
    elif tridiagonal:
        on.append("eigvalsh")
    else:
        on, off = [k for k in on if k != "mod_chol"] + ["eigvalsh"], ["mod_chol"]
    if cfg.psd_method == "gmw" and cfg.grad_mode == "analytic":
        on.append("slack_step")
        if tridiagonal:
            on.remove("factor_solve")
            off.append("factor_solve")
    else:
        off.append("slack_step")
    return (on + ["set_condition"], off) if fused else (on, off + ["set_condition"])


def check_path_launches(label, launches, on, off=(), kernel_nodes=None):
    """Every kernel of ``on`` launched (and, for a fused solve, held as a
    node of its graph), none of ``off``."""
    for name in on:
        check(launches[name] > 0, f"{label}: kernel {name} was never launched")
        if kernel_nodes is not None:
            check(kernel_nodes[name] > 0, f"{label}: kernel {name} has no node in the graph")
    for name in off:
        check(launches[name] == 0, f"{label}: kernel {name} was launched {launches[name]} times")


def check_solution(key, case, row, cfg, consts, state, log):
    """A solve of ``case`` held to its reference: the JAX package's CPU
    float64 row where the case has one (converged, iterations within
    ITER_SLACK, ccd_time and ccd_len within 2%; the C++ row's offsets
    printed beside it), else the C++ gate; clearance >= offset, and for a
    fleet the pairwise clearance by K2."""
    cpp = reference_row(case.cpp[0], **case.cpp[1])
    if case.jax is None:
        check_parity(key, row, cpp, log)
    else:
        check(case.jax["converged"], f"{key}: the JAX row did not converge")
        gap = abs(row["iters"] - case.jax["iters"])
        check(gap <= ITER_SLACK, f"{key}: iterations differ from JAX CPU float64 by {gap}")
        check_parity(key, row, case.jax, log, against="JAX CPU float64")
        dtime = abs(row["ccd_time"] - cpp["ccd_time"]) / cpp["ccd_time"]
        dlen = abs(row["ccd_len"] - cpp["ccd_len"]) / cpp["ccd_len"]
        log(f"  beside C++ {key}: iters {cpp['iters']} / {row['iters']}, ccd_time off "
            f"{dtime * 100:.2f}%, ccd_len off {dlen * 100:.2f}%")
    if case.coupled is not None:
        from trajopt_tpu_torch.solver import driver

        clr = driver.initial_pair_clearance(consts, state)
        log(f"    pairwise clearance by K2 {clr:.5f} (offset {cfg.offset})")
        check(clr >= cfg.offset - 1e-6, f"{key}: pairwise clearance {clr:.6f} below offset")


def _fused_solve(consts, cfg, scene, state0, coupled, max_iters):
    """The fused driver of the case; returns (state, it, gnorm)."""
    from trajopt_tpu_torch.solver import driver, multi

    if coupled is None:
        return driver.solve_fused(consts, cfg, state0, scene, max_iters=max_iters)
    if not cfg.optimal_plane:
        return driver.solve_fused_multi(consts, cfg, state0, scene, coupled, max_iters=max_iters)
    caches = multi.init_multi_caches(cfg, consts, state0.spline.shape[0],
                                     device=state0.spline.device, dtype=state0.spline.dtype)
    return driver.solve_fused_multi_cached(consts, cfg, state0, scene, coupled, caches,
                                           max_iters=max_iters)[:3]


def _fused_carry(consts, cfg, state0):
    """The fused loop's start carry: (state,), and the empty plane caches
    under ``optimal_plane``."""
    from trajopt_tpu_torch.solver import multi

    carry = (state0,)
    if cfg.optimal_plane:
        carry += (multi.init_multi_caches(cfg, consts, state0.spline.shape[0],
                                          device=state0.spline.device,
                                          dtype=state0.spline.dtype),)
    return carry


def solve_busy(cap):
    """(device busy ms, profiled wall ms) of one whole solve of the captured
    loop ``cap`` (`device_busy_share`): one launch in the conditional form,
    the replays up to the flag's false in the select form."""
    def solve():
        while cap.replay():
            pass

    return device_busy_share(solve, 1)


def moved_start(state, eps=1e-7):
    """``state`` with its spline moved by ``eps``, as bench.py:201-205 moves
    the start of each timed call."""
    return state._replace(spline=state.spline + eps)


def check_cache_hits(key, solve, state0, first, want, log):
    """The graph cache (`runtime/cache.py`) behind a fused driver whose
    first call ``first`` (its row: state, it, wall_ms) missed: ``solve(start)
    -> (state, it, gnorm)`` called twice more under `trace.on`, from
    `moved_start` and from ``state0`` again.  Each must hit: 1 graph launch,
    2 host syncs (the final reads), warm-up, capture and instantiation 0.
    The second's state must equal the first call's and ``want`` (the
    host-stepped solve's) bit for bit, and the first call's result must be
    untouched.  Logs whole-call and launch ms per iteration of each."""
    import torch
    from trajopt_tpu_torch.runtime import graph, trace

    kept = [x.clone() for x in first["state"]]
    for name, start in (("moved start", moved_start(state0)), ("first start", state0)):
        out = {}

        def call():
            state, it, gnorm = solve(start)
            out.update(state=state, it=int(it), gnorm=float(gnorm))

        t0 = time.perf_counter()
        with trace.on():
            syncs = sum(count_syncs(call, outside=True).values())
        wall_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        run = graph.LAST_RUN
        it = out["it"]
        log(f"    cache hit from the {name}: {it} iterations, hit {run.hit}, {run.replays} "
            f"launch(es), {syncs} host syncs, warm-up {run.warmup_ms} + capture "
            f"{run.capture_ms} + instantiate {run.instantiate_ms} ms; launch "
            f"{run.replay_ms / max(it, 1):.3f} ms/iter, whole call {wall_ms:.1f} ms = "
            f"{wall_ms / max(it, 1):.3f} ms/iter (the miss: {first['wall_ms'] / first['it']:.3f})")
        check(run.hit, f"{key} from the {name}: the graph cache missed")
        check(run.replays == 1, f"{key} from the {name}: {run.replays} graph launches, expected 1")
        check(syncs == 2, f"{key} from the {name}: {syncs} host syncs, expected 2")
        check(run.warmup_ms == run.capture_ms == run.instantiate_ms == 0.0,
              f"{key} from the {name}: a hit warmed up or captured")
    same = (equal_trees(out["state"], first["state"]) and out["it"] == first["it"]
            and equal_trees(out["state"], want))
    untouched = equal_trees(first["state"], type(first["state"])(*kept))
    log(f"    the hit from the first start bit-equal to the miss and the host-stepped solve: "
        f"{same}; the miss's result untouched by the hits: {untouched}")
    check(same, f"{key}: the cache hit from the first start differs from the miss")
    check(untouched, f"{key}: a cache hit overwrote the first call's result")


def fused_phase(device, cases, host_rows, launches, by_shape, log, select=True):
    """Phases 6 and 8: the fused driver of each of ``cases`` (`SolveCase`)
    on the card at full width, in the conditional form (the drivers'
    default: one graph launch, the solve's WHILE node around the step with
    its IF and WHILE nodes), with the counts set to 0 just before and read
    just after, held to the host-stepped solve of the same run
    (``host_rows``: the same iteration count and a bit-equal final state),
    to its reference (`check_solution`), to the kernels of its path
    (`path_kernels`: launched and held as nodes of the graph,
    ``set_condition`` among them, or not launched), and to host syncs of
    the solve = the 2 final reads (iterations and gnorm) this script makes,
    after 1 graph launch; then, with ``select`` (phase 6), the same loop in
    the select form (`graph.run_fused(form="select")`: one block replayed
    until its flag reads false), held bit-equal to both, with syncs =
    replays + 2.  Prints for each form, from this run: graph launches, replay ms per iteration
    (conditional: the launch between CUDA events; select: the replays on
    the host clock, flag reads included), whole-call ms per iteration,
    warm-up and capture ms, IF and WHILE nodes, the graph's nodes by type,
    kernel nodes per capture and their executions in the solve
    (conditional: from the nodes' ``set_condition`` tallies; select: nodes
    x replays) beside the host-stepped solve's launches; with ``select``
    (phase 6) each form's solve captured again and launched once under
    torch.profiler for device busy ms and idle share over one whole solve
    (`solve_busy`; phase 8 leaves the profiler out, see `log_batch_run`);
    after each conditional call two cache hits (`check_cache_hits`), with
    the miss's pool bytes and peak memory; last every conditional capture
    launched again after `torch.cuda.empty_cache`, and every driver called
    again (a hit), each bit-equal to the host-stepped state
    (`relaunch_after_empty_cache`); the cache cleared.  Returns the rows,
    with the final states."""
    import torch
    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.runtime import cache, graph, trace
    from trajopt_tpu_torch.solver import driver

    fused_rows, held, calls = {}, [], []
    for case in cases:
        cfg, ops, cloud, consts, scene, state0 = case.build(device)
        coupled = case.coupled
        host = host_rows[case.label]
        max_iters = MAX_ITERS if coupled is None else FLEET_MAX_ITERS
        step = driver.fused_step(consts, cfg, scene, coupled, cached=cfg.optimal_plane)
        on, off = path_kernels(cfg, coupled, consts.piece_num, fused=True)
        forms = {}
        for form in ("conditional", "select") if select else ("conditional",):
            out = {}

            def solve():
                if form == "conditional":
                    state, it, gnorm = _fused_solve(consts, cfg, scene, state0, coupled, max_iters)
                else:
                    (state, *_), it, gnorm = graph.run_fused(
                        step, _fused_carry(consts, cfg, state0), max_iters, cfg.stop, form=form)
                out.update(state=state, it=int(it), gnorm=float(gnorm))

            key = f"{case.label} fused" + ("" if form == "conditional" else " select")
            _cuda.reset_launches()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            with trace.on():
                syncs = count_syncs(solve, outside=True)
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            launches[key], by_shape[key] = dict(_cuda.LAUNCHES), shape_counts()
            run = graph.LAST_RUN
            check(run.form == form, f"{key}: ran in the {run.form} form")
            state, it = out["state"], out["it"]
            same = equal_trees(state, host["state"])
            total = sum(syncs.values())
            reads = 2 + (run.replays if form == "select" else 0)
            execs = run.executions()
            forms[form] = dict(it=it, state=state, replays=run.replays, replay_ms=run.replay_ms,
                               wall_ms=wall_ms, syncs=total)
            log(f"  {key}: iters {it} (host-stepped {host['iters']}), gnorm {out['gnorm']:.4g}, "
                f"{run.replays} graph launch(es), final state bit-equal to the host-stepped "
                f"solve's: {same}")
            log(f"    replay {run.replay_ms:.3f} ms = {run.replay_ms / max(it, 1):.3f} ms/iter; "
                f"whole call {wall_ms:.1f} ms = {wall_ms / max(it, 1):.3f} ms/iter; warm-up "
                f"{run.warmup_ms:.1f} ms, capture {run.capture_ms:.1f} ms, instantiate "
                f"{run.instantiate_ms:.1f} ms; host-stepped median "
                f"{host['median_iter_ms']:.3f} ms/iter, mean "
                f"{host['solve_s'] * 1e3 / host['iters']:.3f}")
            log(f"    graph pool {run.pool_bytes} bytes; peak allocated in the call {peak} bytes; "
                f"cache hit {run.hit}")
            cap = graph.capture(step, _fused_carry(consts, cfg, state0), max_iters, cfg.stop, form)
            if select:
                busy, busy_wall = solve_busy(cap)
                forms[form].update(busy=busy, busy_wall=busy_wall)
                log(f"    one whole solve under torch.profiler: device busy {busy:.3f} ms of "
                    f"{busy_wall:.3f} ms wall, idle share {1.0 - busy / busy_wall:.3f}")
            if form == "conditional":
                held.append((key, cap, host["state"], step))
            del cap
            log(f"    conditional nodes: {run.cond_nodes or 'none'}")
            log("    kernel nodes per capture / executions in the solve / host-stepped launches: "
                + ", ".join(f"{k} {v} / {execs.get(k, 0)} / {launches.get(case.label, {}).get(k, '-')}"
                            for k, v in run.kernel_nodes.items()))
            if form == "conditional":
                log_launches(key, launches[key], by_shape[key], log)
            log(f"    host syncs in the whole fused solve: {total}")
            for line, n in sorted(syncs.items()):
                log(f"      {n:3d}  {line}")
            check_path_launches(key, launches[key], *((on, off) if form == "conditional" else
                                                     ([k for k in on if k != "set_condition"],
                                                      off + ["set_condition"])),
                                kernel_nodes=run.kernel_nodes)
            check(it == host["iters"], f"{key}: {it} iterations, the host-stepped solve took "
                                       f"{host['iters']}")
            check(same, f"{key}: the final state differs from the host-stepped solve's")
            check(total == reads, f"{key}: {total} host syncs, expected {reads} (flag reads and "
                                  "the 2 final reads)")
            if form == "conditional":
                check(run.replays == 1, f"{key}: {run.replays} graph launches, expected 1")
                # the nodes' tallies against the host-stepped solve's launches,
                # which its start-up clearance check raises by at most one
                host_launches = launches.get(case.label, {})
                extra = {k: n - execs.get(k, 0) for k, n in host_launches.items()
                         if k != "set_condition"}
                check(all(0 <= n <= 1 for n in extra.values()),
                      f"{key}: kernel executions {execs}, the host-stepped solve launched "
                      f"{host_launches}")
                quality = (single_quality if coupled is None else fleet_quality)(ops, cloud, state)
                row = {"iters": it, "gnorm": out["gnorm"], "offset": cfg.offset,
                       "converged": it < max_iters and out["gnorm"] < cfg.stop, **quality}
                fused_rows[case.label] = dict(row, state=state)
                check_solution(key, case, row, cfg, consts, state, log)
                check(not run.hit, f"{key}: the first call hit the graph cache")
                solve_cached = (lambda start, c=consts, g=cfg, sc=scene, cp=coupled, n=max_iters:
                                _fused_solve(c, g, sc, start, cp, n))
                check_cache_hits(key, solve_cached, state0, dict(out, wall_ms=wall_ms),
                                 host["state"], log)
                calls.append((key, lambda f=solve_cached, s=state0: f(s)[0], host["state"]))
        if not select:
            continue
        c, s_ = forms["conditional"], forms["select"]
        check(equal_trees(c["state"], s_["state"]) and c["it"] == s_["it"],
              f"{case.label}: the conditional and select forms differ")
        log(f"  {case.label} conditional / select: replay ms/iter {c['replay_ms'] / c['it']:.3f} / "
            f"{s_['replay_ms'] / s_['it']:.3f}, whole call ms/iter {c['wall_ms'] / c['it']:.3f} / "
            f"{s_['wall_ms'] / s_['it']:.3f}, graph launches {c['replays']} / {s_['replays']}, host "
            f"syncs {c['syncs']} / {s_['syncs']}, busy ms {c['busy']:.3f} / {s_['busy']:.3f} "
            f"(select extra {(s_['busy'] - c['busy']) / c['it']:.3f} ms/iter), idle share "
            f"{1 - c['busy'] / c['busy_wall']:.3f} / {1 - s_['busy'] / s_['busy_wall']:.3f}; "
            f"bit-equal")
    relaunch_after_empty_cache(held, log, calls)
    cache.clear()
    return fused_rows


# ---------------------------------------------------------------------------
# Phase 7: batches and sharding
# ---------------------------------------------------------------------------

BATCH_SIZES = (16, 1024)    # bench_scale.py's single-UAV batches: the smallest and the largest
FLEET_BATCHES = (4, 16)     # bench_scale.py's coupled fleet batches (run_batched)
BATCH_POINTS = 2000         # bench_scale.py's n_points for both
BATCH_ITERS = 50            # bench_scale.py's fixed iteration count (stop = 0)
BATCH_FLEET = 4             # robots a fleet in bench_scale.py's run_batched
GATE_BATCH = 16             # the convergence gate's batch (scenario 0 unjittered)
# a batch's scenario (fleet) against its own solve after 50 iterations, max
# abs over splines and piece times (metres, seconds).  The same math in
# float32 rounds otherwise at other batch shapes: phase 7 (a) prints how a
# single UAV's difference grows while the path moves (0.048 at iteration 10
# on the card, a different rung taken) and shrinks once both solves have
# converged to one trajectory (9e-4 at 50 on an H100, PERF.md): 5x that, 5% of
# the offset
BATCH_MATCH_TOL = 5e-3


def jittered(state, b, device, unjittered_first=False):
    """``b`` copies of ``state`` with bench_scale.py's spline jitter
    (normal, scale 1e-3, `np.random.default_rng(0)`), stacked [b, ...]."""
    import numpy as np
    import torch
    from trajopt_tpu_torch import types as tt

    deltas = np.random.default_rng(0).normal(scale=1e-3, size=(b,) + tuple(state.spline.shape))
    if unjittered_first:
        deltas[0] = 0.0
    states = tt.stack([state] * b)
    return states._replace(spline=states.spline + torch.as_tensor(deltas, dtype=state.spline.dtype,
                                                                  device=device))


def build_batch(b, device, n_points=BATCH_POINTS, stop=0.0, unjittered_first=False):
    """bench_scale.py's run_batched_single problem: the bridge at P=4 (2000
    points), phase 3's config with ``stop`` (0: fixed iterations; None: the
    default), ``b`` jittered scenarios sharing the scene."""
    import torch

    cfg, ops, cloud, consts, scene, state0 = build_problem(4, device, torch.float32)
    cfg = cfg if stop is None else cfg.replace(stop=stop)
    if n_points != N_POINTS:
        from trajopt_tpu_torch import types as tt
        from trajopt_tpu_torch.scenes import generators as gen

        cloud, _ = gen.bridge_scene(n_points=n_points, seed=0, n_pieces=4)
        scene = tt.make_scene(cloud, device=device, dtype=torch.float32)
    return cfg, ops, cloud, consts, scene, jittered(state0, b, device, unjittered_first)


def build_fleet_batch(b, device):
    """bench_scale.py's run_batched problem (__graft_entry__._build_problem):
    the 4-robot cross of 2000 points, P=4, res 8, max_planes 16,
    max_self_planes 4, max_ccd_candidates 16, stop 0; ``b`` jittered fleets
    [b, 4, ...] sharing the scene."""
    import torch
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.config import TrajOptConfig
    from trajopt_tpu_torch.ops import splines as sp
    from trajopt_tpu_torch.scenes import generators as gen
    from trajopt_tpu_torch.solver import multi

    cfg = TrajOptConfig(res=8, ks=1e-3, max_planes=16, max_self_planes=4, max_ccd_candidates=16,
                        stop=0.0)
    cloud = gen.cross_scene(n_points=BATCH_POINTS, seed=0)
    wps = gen.assign_lanes(gen.cross_waypoints(BATCH_FLEET, FLEET_PIECES), cloud)
    ops = sp.build_spline_ops(FLEET_PIECES, cfg.res)
    kw = dict(device=device, dtype=torch.float32)
    state0 = multi.init_multi_state(ops, wps, cfg.init_piece_time, **kw)
    return (cfg, ops, cloud, tt.device_consts(ops, **kw), tt.make_scene(cloud, **kw),
            jittered(state0, b, device))


def batch_clearances(ops, cloud, splines, times, device):
    """[B] min curve clearance of each trajectory (`metrics.min_curve_clearance`'s
    samples, dt 0.02, distances on the card in float64)."""
    import numpy as np
    import torch
    from trajopt_tpu_torch import metrics as mt

    cloud_t = torch.as_tensor(np.asarray(cloud), dtype=torch.float64, device=device)
    out = []
    for s, t in zip(splines, times):
        pts = torch.as_tensor(mt.sample_trajectory(ops, s, float(t), dt=0.02),
                              dtype=torch.float64, device=device)
        out.append(torch.cdist(pts, cloud_t).amin())
    return torch.stack(out).cpu().numpy()


def run_fused_path(label, solve, launches, by_shape, log, on_path=FUSED_KERNELS, off_path=()):
    """``solve()`` (a fused driver call) with the launch counts set to 0
    just before and read just after; every kernel of ``on_path`` must have
    been launched and hold a node in the graph, none of ``off_path``
    launched.  Returns (result, wall ms, `graph.LAST_RUN`)."""
    import torch
    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.runtime import graph, trace

    _cuda.reset_launches()
    t0 = time.perf_counter()
    with trace.on():
        out = solve()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches[label], by_shape[label] = dict(_cuda.LAUNCHES), shape_counts()
    run = graph.LAST_RUN
    check_path_launches(label, launches[label], on_path, off_path, run.kernel_nodes)
    return out, wall_ms, run


def log_batch_run(label, b, it, wall_ms, run, log):
    """What (a) and (c) report of one fused batch solve (conditional form:
    one graph launch).  No device busy share: under torch.profiler CUPTI
    records the kernels of conditional bodies for about 330k records in a
    process, then none, and a later profiled launch faults with an illegal
    address, also in a graph of plain torch ops that runs clean unprofiled
    (`tools/cond_fault_check.py`'s heavy cases; PERF.md, section 6).
    Phase 6's five profiled solves stay below that; phases 7-8 relaunch
    their solves unprofiled (`relaunch_after_empty_cache`)."""
    log(f"  {label}: {it} iterations of {b} scenarios; warm-up {run.warmup_ms:.1f} + capture "
        f"{run.capture_ms:.1f} + instantiate {run.instantiate_ms:.1f} ms (graph pool "
        f"{run.pool_bytes} bytes), {run.replays} launch {run.replay_ms:.1f} ms = "
        f"{run.replay_ms / max(it, 1):.3f} ms/iter, {b * it / (run.replay_ms / 1e3):.1f} "
        f"scenario-iterations/s over the launch ({b * it / (wall_ms / 1e3):.1f} over the whole "
        f"call of {wall_ms:.1f} ms)")
    execs = run.executions()
    log(f"    nodes {run.cond_nodes}; kernel nodes per capture / executions in the solve: "
        + ", ".join(f"{k} {v} / {execs.get(k, 0)}" for k, v in run.kernel_nodes.items()))


def relaunch_after_empty_cache(held, log, calls=()):
    """Each captured solve of ``held`` ((label, conditional-form
    `graph.Captured`, the state it must end in, its step)) launched with no
    profiler after one `torch.cuda.empty_cache` has returned every free
    cached block to the driver, its final state held to the expected one
    bit for bit: a graph that read memory it does not own (such as a block
    the shared pool freed after the capture) faults or differs.  The step
    is held because its closure holds the constants and the scene the
    graph reads.  Then each of ``calls`` ((label, a fused driver call
    returning its state, the state it must end in)), made under
    `trace.on` as the phases' first calls are, which must hit the
    graph cache (`runtime/cache.py`), held to it in the same way.  Run at
    the end of a phase, since the emptied cache slows the allocations
    after it."""
    import torch
    from trajopt_tpu_torch.runtime import graph, trace

    torch.cuda.empty_cache()
    for label, cap, want, _step in held:
        cap.replay()
        torch.cuda.synchronize()
        check(equal_trees(cap.carry[0], want), f"{label}: the solve launched after "
                                               "torch.cuda.empty_cache differs")
    for label, call, want in calls:
        with trace.on():
            got = call()
        torch.cuda.synchronize()
        check(graph.LAST_RUN.hit, f"{label}: the call after torch.cuda.empty_cache missed the "
                                  "graph cache")
        check(equal_trees(got, want), f"{label}: the cache hit after torch.cuda.empty_cache "
                                      "differs")
    log(f"  relaunched after torch.cuda.empty_cache, each bit-equal: "
        f"{', '.join(entry[0] for entry in held)}"
        + "".join(f"; cache hit {label}" for label, _, _ in calls))
    held.clear()


def check_hit_against_fresh(label, solve, start, step, max_iters, stop, log):
    """``solve(start) -> (state, it, gnorm)``, a fused driver call of a
    key that an earlier call under `trace.on` captured, which must
    hit the graph cache (1 launch, no warm-up or capture), held bit for bit
    to a fresh capture of ``step`` from ``start`` (uncached
    `graph.run_fused`)."""
    import torch
    from trajopt_tpu_torch.runtime import graph, trace

    t0 = time.perf_counter()
    with trace.on():
        got, it, _ = solve(start)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    run = graph.LAST_RUN
    it = int(it)
    (fresh,), fresh_it, _ = graph.run_fused(step, (start,), max_iters, stop)
    same = equal_trees(got, fresh) and it == int(fresh_it)
    log(f"  {label} cache hit: hit {run.hit}, {run.replays} launch(es), warm-up "
        f"{run.warmup_ms} + capture {run.capture_ms} ms, {it} iterations, launch "
        f"{run.replay_ms / max(it, 1):.3f} ms/iter, whole call {wall_ms:.1f} ms; bit-equal to a "
        f"fresh capture: {same}")
    check(run.hit and run.replays == 1 and run.warmup_ms == run.capture_ms == 0.0,
          f"{label}: the second call did not hit the graph cache")
    check(same, f"{label}: the cache hit differs from a fresh capture")


def max_diff(a, b):
    """Largest abs difference over splines and piece times of two states."""
    return max(float((a.spline - b.spline).abs().max()),
               float((a.piece_time - b.piece_time).abs().max()))


def first_step_overflow(consts, cfg, states, scene, **options):
    """The plane-budget overflow flag of one host-stepped step from the
    start (the batch pools every scenario's candidates into one budget)."""
    from trajopt_tpu_torch.solver import multi

    return bool(multi.multi_admm_step(consts, cfg, states, scene, **options)[1].plane_overflow)


def batch_single_phase(device, launches, by_shape, log):
    """Phase 7 (a) and (b): `solve_fused_batch` at bench_scale.py's batches,
    then the convergence gate."""
    import numpy as np
    import torch
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.runtime import cache, graph
    from trajopt_tpu_torch.solver import driver

    held = []
    for b in BATCH_SIZES:
        t0 = time.perf_counter()
        cfg, ops, cloud, consts, scene, states = build_batch(b, device)
        label = f"batch{b} single p4 fused"
        (out, it, gnorm), wall_ms, run = run_fused_path(
            label, lambda: driver.solve_fused_batch(consts, cfg, states, scene,
                                                    max_iters=BATCH_ITERS),
            launches, by_shape, log)
        it = int(it)
        check(it == BATCH_ITERS, f"{label}: {it} iterations, stop 0 runs {BATCH_ITERS}")
        step = driver.fused_step(consts, cfg, scene, False, interact=False)
        log_batch_run(label, b, it, wall_ms, run, log)
        held.append((label, graph.capture(step, (states,), BATCH_ITERS, cfg.stop), out, step))
        log(f"    launches {launches[label]}")
        log(f"    launches by call shape: {by_shape[label]}")
        if b == BATCH_SIZES[0]:
            noise = np.random.default_rng(1).normal(scale=1e-3, size=tuple(states.spline.shape))
            other = states._replace(spline=states.spline + torch.as_tensor(
                noise, dtype=states.spline.dtype, device=device))
            check_hit_against_fresh(
                f"{label} from new jitter",
                lambda s: driver.solve_fused_batch(consts, cfg, s, scene, max_iters=BATCH_ITERS),
                other, step, BATCH_ITERS, cfg.stop, log)
        overflow = first_step_overflow(consts, cfg, states, scene, coupled=False, interact=False)
        log(f"    plane budget overflow in the first step: {overflow}; mean gnorm {float(gnorm):.4g}")
        if b == BATCH_SIZES[0]:
            # how the difference from its own solve evolves (BATCH_MATCH_TOL)
            drift = []
            for k in (10, 20, 30, 40):
                part = driver.solve_fused_batch(consts, cfg, states, scene, max_iters=k)[0]
                own = driver.solve_fused(consts, cfg, tt.index(states, 0), scene, max_iters=k)[0]
                drift.append(f"{k}: {max_diff(tt.index(part, 0), own):.3g}")
            log(f"    scenario 0 against its own solve_fused after k iterations: {', '.join(drift)}")
        for i in (0, b // 2 - 1, b - 1):
            ref, ref_it, _ = driver.solve_fused(consts, cfg, tt.index(states, i), scene,
                                                max_iters=BATCH_ITERS)
            diff = max_diff(tt.index(out, i), ref)
            log(f"    scenario {i} against its own solve_fused ({int(ref_it)} iterations): "
                f"max |batch - own| over spline and piece time {diff:.3g} "
                f"(held to {BATCH_MATCH_TOL:g})")
            check(diff <= BATCH_MATCH_TOL, f"{label}: scenario {i} off its own solve by {diff:.3g}")
        splines = out.spline.detach().double().cpu().numpy()
        times = out.piece_time.detach().double().cpu().numpy()
        clr = batch_clearances(ops, cloud, splines, times, device)
        log(f"    curve clearance over the {b} scenarios: min {clr.min():.5f}, max {clr.max():.5f} "
            f"(offset {cfg.offset}); piece time {times.min():.4f} to {times.max():.4f}; "
            f"case {time.perf_counter() - t0:.1f} s")
        check(bool((clr >= cfg.offset).all()), f"{label}: a scenario's clearance is below offset")
        check(bool((times > 0).all()), f"{label}: a piece time is not positive")

    # (b) the convergence gate: phase 3's problem, default stop, the mean gnorm
    t0 = time.perf_counter()
    cfg, ops, cloud, consts, scene, states = build_batch(GATE_BATCH, device, n_points=N_POINTS,
                                                         stop=None, unjittered_first=True)
    label = f"batch{GATE_BATCH} single p4 gate fused"
    (out, it, gnorm), wall_ms, run = run_fused_path(
        label, lambda: driver.solve_fused_batch(consts, cfg, states, scene, max_iters=MAX_ITERS),
        launches, by_shape, log)
    it, gnorm = int(it), float(gnorm)
    quality = single_quality(ops, cloud, tt.index(out, 0))
    row = {"iters": it, "gnorm": gnorm, "offset": cfg.offset,
           "converged": it < MAX_ITERS and gnorm < cfg.stop, **quality}
    log(f"  {label}: {it} iterations, mean gnorm {gnorm:.4g} (stop {cfg.stop}), the launch "
        f"{run.replay_ms / max(it, 1):.3f} ms/iter, whole call {wall_ms:.1f} ms")
    check(row["converged"], f"{label}: the mean gnorm did not fall below stop in {MAX_ITERS}")
    check_parity(f"{label} scenario 0", row, reference_row("single", pieces=4), log)
    splines = out.spline.detach().double().cpu().numpy()
    times = out.piece_time.detach().double().cpu().numpy()
    clr = batch_clearances(ops, cloud, splines, times, device)
    log(f"    curve clearance over the {GATE_BATCH} scenarios: min {clr.min():.5f} (offset "
        f"{cfg.offset}); case {time.perf_counter() - t0:.1f} s")
    check(bool((clr >= cfg.offset).all()), f"{label}: a scenario's clearance is below offset")
    relaunch_after_empty_cache(held, log)
    cache.clear()


def fleet_batch_phase(device, launches, by_shape, log):
    """Phase 7 (c): `solve_fused_batch_multi` at bench_scale.py's fleet
    batches, coupled (and decoupled at the first), each fleet's pair
    clearance by K2 cross-checked by K5, fleets 0 and B-1 against their own
    `solve_fused_multi` (which also shows that no robot is held back by
    another fleet's: the fleets' jittered copies overlap in space)."""
    import torch
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.runtime import cache, graph
    from trajopt_tpu_torch.solver import driver

    held = []
    runs = [(b, True) for b in FLEET_BATCHES] + [(FLEET_BATCHES[0], False)]
    for b, coupled in runs:
        t0 = time.perf_counter()
        mode = "coupled" if coupled else "decoupled"
        cfg, ops, cloud, consts, scene, states = build_fleet_batch(b, device)
        label = f"batch{b} u{BATCH_FLEET} {mode} fused"
        (out, it, gnorm), wall_ms, run = run_fused_path(
            label, lambda: driver.solve_fused_batch_multi(consts, cfg, states, scene,
                                                          coupled=coupled, max_iters=BATCH_ITERS),
            launches, by_shape, log)
        it = int(it)
        check(it == BATCH_ITERS, f"{label}: {it} iterations, stop 0 runs {BATCH_ITERS}")
        flat = tt.SolverState(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in states))
        step = driver.fused_step(consts, cfg, scene, coupled, groups=b)
        log_batch_run(label, b, it, wall_ms, run, log)
        held.append((label, graph.capture(step, (flat,), BATCH_ITERS, cfg.stop),
                     tt.SolverState(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in out)), step))
        log(f"    launches {launches[label]}")
        log(f"    launches by call shape: {by_shape[label]}")
        overflow = first_step_overflow(consts, cfg, flat, scene, coupled=coupled, groups=b)
        log(f"    plane budget overflow in the first step: {overflow}; mean gnorm {float(gnorm):.4g}")
        for i in (0, b - 1):
            ref, _, _ = driver.solve_fused_multi(consts, cfg, tt.index(states, i), scene, coupled,
                                                 max_iters=BATCH_ITERS)
            diff = max_diff(tt.index(out, i), ref)
            log(f"    fleet {i} against its own solve_fused_multi: max |batch - own| over "
                f"splines and piece times {diff:.3g} (held to {BATCH_MATCH_TOL:g})")
            check(diff <= BATCH_MATCH_TOL, f"{label}: fleet {i} off its own solve by {diff:.3g}")
        _cuda.reset_launches()
        for i in range(b):
            pair_clearance_check(cfg, consts, tt.index(out, i), log)
        torch.cuda.synchronize()
        launches[f"{label} pair clearance"] = dict(_cuda.LAUNCHES)
        check(_cuda.LAUNCHES["gjk_fw"] > 0, "K5 was never launched by the clearance cross-check")
        quality = fleet_quality(ops, cloud, tt.SolverState(*(x.reshape((-1,) + tuple(x.shape[2:]))
                                                            for x in out)))
        log(f"    curve clearance over the {b * BATCH_FLEET} robots: {quality['min_clearance']:.5f} "
            f"(offset {cfg.offset}); case {time.perf_counter() - t0:.1f} s")
        check(quality["min_clearance"] >= cfg.offset, f"{label}: clearance below offset")
        check(bool((out.piece_time > 0).all()), f"{label}: a piece time is not positive")
    relaunch_after_empty_cache(held, log)
    cache.clear()


def equal_trees(a, b):
    """Every leaf of two containers (or two tensors) equal, bit for bit."""
    import torch

    if torch.is_tensor(a):
        return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))
    return all(equal_trees(x, y) for x, y in zip(a, b, strict=True))


def sharding_phase(device, fused_rows, launches, by_shape, log):
    """Phase 7 (d): sharding on the one card, a single-rank NCCL group
    (`make_mesh(1)`): the sharded step, the fused multi solve with
    ``axis_name``, the 2-D mesh step, the scenario-sharded solver and the
    CLI's ``--mesh-devices 1`` under torchrun, each against its unsharded
    counterpart, bit for bit."""
    import contextlib
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.parallel import sharded
    from trajopt_tpu_torch.runtime import cache
    from trajopt_tpu_torch.scenes import generators as gen
    from trajopt_tpu_torch.solver import driver, multi

    check(not dist.is_initialized(), "a process group exists before phase 7 (d)")
    mesh = sharded.make_mesh(1)
    group = mesh.get_group(sharded.ROBOT_AXIS)
    log(f"  mesh {mesh}, backend {dist.get_backend(group)}")
    try:
        cfg, ops, cloud, consts, scene, state0 = build_fleet(FLEET, device, torch.float32)
        # from phase 6's converged cross, where every kernel of the step runs
        settled = fused_rows[f"u{FLEET} coupled"]["state"]
        for coupled in (True, False):
            mode = "coupled" if coupled else "decoupled"
            label = f"u{FLEET} {mode} sharded step x3"
            step = sharded.sharded_multi_step(consts, cfg, mesh, coupled)
            _cuda.reset_launches()
            state, same = settled, True
            for _ in range(3):
                got = step(state, scene)
                want = multi.multi_admm_step(consts, cfg, state, scene, coupled)
                same &= equal_trees(got[0], want[0]) and equal_trees(got[1], want[1])
                state = got[0]
            torch.cuda.synchronize()
            launches[label], by_shape[label] = dict(_cuda.LAUNCHES), shape_counts()
            log(f"  {label}: states and diags bit-equal to multi_admm_step: {same}")
            check(same, f"{label}: the sharded step differs from multi_admm_step")
            check_path_launches(label, launches[label], SOLVE_KERNELS, ("eigvalsh", "set_condition"))

        label = f"u{FLEET} coupled fused axis_name"
        (state, it, gnorm), wall_ms, run = run_fused_path(
            label, lambda: driver.solve_fused_multi(consts, cfg, state0, scene, True,
                                                    max_iters=FLEET_MAX_ITERS, axis_name=group),
            launches, by_shape, log)
        ref = fused_rows[f"u{FLEET} coupled"]
        same = (np.array_equal(state.spline.detach().double().cpu().numpy(), ref["spline"])
                and np.array_equal(state.piece_time.detach().double().cpu().numpy(),
                                   ref["piece_time"]))
        log(f"  {label}: {int(it)} iterations (phase 6: {ref['iters']}), state bit-equal to phase "
            f"6's: {same}; {run.form} form, {run.replays} launch(es) "
            f"{run.replay_ms / max(int(it), 1):.3f} ms/iter, warm-up {run.warmup_ms:.1f} + "
            f"capture {run.capture_ms:.1f} ms, nodes {run.cond_nodes}, kernel nodes "
            f"{run.kernel_nodes}")
        check(int(it) == ref["iters"], f"{label}: {int(it)} iterations, phase 6 took {ref['iters']}")
        check(same, f"{label}: the final state differs from phase 6's")
        check_hit_against_fresh(
            f"{label} from the moved start",
            lambda s: driver.solve_fused_multi(consts, cfg, s, scene, True,
                                               max_iters=FLEET_MAX_ITERS, axis_name=group),
            moved_start(state0), driver.fused_step(consts, cfg, scene, True, axis_name=group),
            FLEET_MAX_ITERS, cfg.stop, log)

        label = f"2-D mesh (1, 1), 2 scenarios of u{FLEET}"
        mesh2 = sharded.make_mesh_2d(1, 1)
        lower = scene._replace(points=scene.points - torch.tensor([0.0, 0.0, 0.2], device=device))
        states, scenes = jittered(settled, 2, device), tt.stack([scene, lower])
        _cuda.reset_launches()
        got, diags = sharded.sharded_multi_step_2d(consts, cfg, mesh2, True)(states, scenes)
        torch.cuda.synchronize()
        launches[label], by_shape[label] = dict(_cuda.LAUNCHES), shape_counts()
        same = True
        for i in range(2):
            want, want_diag = multi.multi_admm_step(consts, cfg, tt.index(states, i),
                                                    tt.index(scenes, i), True)
            same &= equal_trees(tt.index(got, i), want) and equal_trees(tt.index(diags, i), want_diag)
        log(f"  {label}: each scenario bit-equal to its multi_admm_step: {same}")
        check(same, f"{label}: differs from the per-scenario steps")
        check_path_launches(label, launches[label], SOLVE_KERNELS, ("eigvalsh", "set_condition"))

        label = "scenario-sharded bridge solves, 4 scenes"
        scfg, sops, _, sconsts, _, sstate = build_problem(4, device, torch.float32)
        sscenes = tt.stack([tt.make_scene(gen.bridge_scene(n_points=BATCH_POINTS, seed=s,
                                                           n_pieces=4)[0],
                                          device=device, dtype=torch.float32) for s in range(4)])
        sstates = jittered(sstate, 4, device)
        smesh = sharded.make_mesh(1, sharded.SCENARIO_AXIS)
        _cuda.reset_launches()
        got, its, gnorms = sharded.scenario_sharded_solver(sconsts, scfg, smesh)(sstates, sscenes)
        torch.cuda.synchronize()
        launches[label], by_shape[label] = dict(_cuda.LAUNCHES), shape_counts()
        same = True
        for i in range(4):
            want, it, gnorm = driver.solve_fused(sconsts, scfg, tt.index(sstates, i),
                                                 tt.index(sscenes, i))
            same &= (equal_trees(tt.index(got, i), want) and int(its[i]) == int(it)
                     and equal_trees(gnorms[i], gnorm))
        log(f"  {label}: iterations {its.tolist()}, each bit-equal to its solve_fused: {same}")
        check(same, f"{label}: differs from the per-scenario solves")
        check_path_launches(label, launches[label], FUSED_KERNELS, ("eigvalsh",))
    finally:
        cache.clear()       # its keys hold the group
        dist.destroy_process_group()

    # the CLI under torchrun, one process, against the unsharded CLI
    from trajopt_tpu_torch.cli import multi as cli

    # bounded: this synthetic cross (no lane assignment) stalls one robot at
    # the offset and never meets the stop, so the CLI would run forever
    args = ["--scene", "cross", "--uav-num", str(BATCH_FLEET), "--max-iters", "10"]
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
               "1", "-m", "trajopt_tpu_torch.cli.multi", *args, "--mesh-devices", "1",
               "--result-dir", os.path.join(tmp, "sharded"),
               "--metrics", os.path.join(tmp, "sharded.jsonl")]
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True, timeout=240)
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"torchrun --mesh-devices 1 failed ({proc.returncode}):\n"
                                    f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with contextlib.redirect_stdout(sys.stderr):     # stdout ends with the JSON lines
            rc = cli.main(args + ["--result-dir", os.path.join(tmp, "plain"),
                                  "--metrics", os.path.join(tmp, "plain.jsonl")])
        check(rc == 0, "the unsharded CLI failed")
        name = "cross_synthetic_result_file_admm.txt"
        files = [open(os.path.join(tmp, d, name)).read().splitlines() for d in ("sharded", "plain")]
        rows = [[json.loads(line) for line in open(os.path.join(tmp, f"{d}.jsonl"))]
                for d in ("sharded", "plain")]
        strip = lambda rs: [{k: v for k, v in r.items() if k != "wall_ms"} for r in rs]
        log(f"  torchrun --nproc-per-node 1 cli.multi --mesh-devices 1 ({sub_s:.1f} s): result "
            f"{files[0]}, unsharded {files[1]}; metrics rows equal apart from wall_ms: "
            f"{strip(rows[0]) == strip(rows[1])}")
        check(files[0][0] == files[1][0] and files[0][2:] == files[1][2:],
              "the sharded CLI's result file differs from the unsharded one's")
        check(strip(rows[0]) == strip(rows[1]), "the sharded CLI's metrics differ")
        for line in proc.stdout.splitlines():
            if line.startswith("uav "):
                log("    " + line)



# ---------------------------------------------------------------------------
# Phase 8: every PSD repair on every driver
# ---------------------------------------------------------------------------

PSD_METHODS = ("eigh", "ladder")
PSD_BATCH = 16              # phase 7's smallest single-UAV batch


def psd_cases():
    """Phase 8's solves (`SolveCase`): the bridge at P=4 and the 64-robot
    cross coupled with each method; "eigh" held to the C++ gate, the ladder
    to the JAX package's CPU float64 row (`testing.PSD_JAX_ROWS`)."""
    import torch
    from trajopt_tpu_torch.testing import PSD_JAX_ROWS

    f32, p = torch.float32, SLICE_PIECES[0]
    cases = []
    for method in PSD_METHODS:
        for name, build, coupled, cpp in (
                (f"single p{p}", lambda d, m=method: build_problem(p, d, f32, psd_method=m), None,
                 ("single", dict(pieces=p))),
                (f"u{FLEET} coupled", lambda d, m=method: build_fleet(FLEET, d, f32, psd_method=m),
                 True, ("coupled", dict(uavs=FLEET)))):
            name = f"{name} {method}"
            cases.append(SolveCase(f"phase 8 {name}", build, coupled, cpp,
                                   PSD_JAX_ROWS[name] if method == "ladder" else None))
    return cases


def psd_host_phase(device, cases, launches, by_shape, log):
    """Phase 8's host-stepped solves (`host_solve`), each with the counts
    set to 0 just before and read just after: the kernels of its path
    launched and the other repair's not (`path_kernels`), held to its
    reference (`check_solution`), and the host syncs of one steady
    iteration from its converged state.  Returns the rows."""
    import torch
    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.solver import driver

    rows = {}
    for case in cases:
        cfg, _, _, consts, scene, _ = problem = case.build(device)
        max_iters = MAX_ITERS if case.coupled is None else FLEET_MAX_ITERS
        key = case.label
        _cuda.reset_launches()
        row = rows[key] = host_solve(problem, case.coupled, max_iters)
        torch.cuda.synchronize()
        launches[key], by_shape[key] = dict(_cuda.LAUNCHES), shape_counts()
        log(f"  {key} host-stepped: iters {row['iters']}, gnorm {row['gnorm']:.4g}, median "
            f"{row['median_iter_ms']:.2f} ms/iter, solve {row['solve_s']:.2f} s")
        log_launches(key, launches[key], by_shape[key], log)
        check_path_launches(key, launches[key], *path_kernels(cfg, case.coupled, consts.piece_num))
        check_solution(key, case, row, cfg, consts, row["state"], log)
        step = driver.fused_step(consts, cfg, scene, case.coupled)
        steady = lambda: step((row["state"],))
        steady()
        log_syncs(f"steady {key} (from its converged state)", count_syncs(steady), log)
    return rows


def psd_batch(device, method, launches, by_shape, log):
    """`solve_fused_batch` at phase 7's B = 16 (bench_scale.py's bridge
    batch, 50 iterations at stop 0) with ``psd_method=method``: the kernels
    of its path (`path_kernels`), scenarios 0, 7 and 15 within
    BATCH_MATCH_TOL of their own `solve_fused`, every scenario's clearance
    >= offset; last the solve relaunched after `torch.cuda.empty_cache`."""
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.runtime import cache, graph
    from trajopt_tpu_torch.solver import driver

    cfg, ops, cloud, consts, scene, states = build_batch(PSD_BATCH, device)
    cfg = cfg.replace(psd_method=method)
    label = f"phase 8 batch{PSD_BATCH} single p4 {method} fused"
    on, off = path_kernels(cfg, None, consts.piece_num, fused=True)
    (out, it, gnorm), wall_ms, run = run_fused_path(
        label, lambda: driver.solve_fused_batch(consts, cfg, states, scene, max_iters=BATCH_ITERS),
        launches, by_shape, log, on_path=on, off_path=off)
    it = int(it)
    check(it == BATCH_ITERS, f"{label}: {it} iterations, stop 0 runs {BATCH_ITERS}")
    step = driver.fused_step(consts, cfg, scene, False, interact=False)
    log_batch_run(label, PSD_BATCH, it, wall_ms, run, log)
    held = [(label, graph.capture(step, (states,), BATCH_ITERS, cfg.stop), out, step)]
    log_launches(label, launches[label], by_shape[label], log)
    for i in (0, PSD_BATCH // 2 - 1, PSD_BATCH - 1):
        ref, _, _ = driver.solve_fused(consts, cfg, tt.index(states, i), scene, max_iters=BATCH_ITERS)
        diff = max_diff(tt.index(out, i), ref)
        log(f"    scenario {i} against its own solve_fused: max |batch - own| over spline and "
            f"piece time {diff:.3g} (held to {BATCH_MATCH_TOL:g})")
        check(diff <= BATCH_MATCH_TOL, f"{label}: scenario {i} off its own solve by {diff:.3g}")
    splines = out.spline.detach().double().cpu().numpy()
    times = out.piece_time.detach().double().cpu().numpy()
    clr = batch_clearances(ops, cloud, splines, times, device)
    log(f"    curve clearance over the {PSD_BATCH} scenarios: min {clr.min():.5f} (offset "
        f"{cfg.offset}), mean gnorm {float(gnorm):.4g}")
    check(bool((clr >= cfg.offset).all()), f"{label}: a scenario's clearance is below offset")
    relaunch_after_empty_cache(held, log)
    cache.clear()


def psd_sharded(device, fused_state, launches, by_shape, log):
    """The 64-robot cross coupled with ``psd_method="ladder"`` through
    `solve_fused_multi(axis_name=...)` on a single-rank NCCL group: bit-equal
    to this phase's unsharded fused ladder solve."""
    import torch
    import torch.distributed as dist
    from trajopt_tpu_torch.parallel import sharded
    from trajopt_tpu_torch.runtime import cache
    from trajopt_tpu_torch.solver import driver

    mesh = sharded.make_mesh(1)
    try:
        cfg, _, _, consts, scene, state0 = build_fleet(FLEET, device, torch.float32,
                                                       psd_method="ladder")
        label = f"phase 8 u{FLEET} coupled ladder fused axis_name"
        on, off = path_kernels(cfg, True, consts.piece_num, fused=True)
        (state, it, _), _, run = run_fused_path(
            label, lambda: driver.solve_fused_multi(consts, cfg, state0, scene, True,
                                                    max_iters=FLEET_MAX_ITERS,
                                                    axis_name=mesh.get_group(sharded.ROBOT_AXIS)),
            launches, by_shape, log, on_path=on, off_path=off)
        same = equal_trees(state, fused_state)
        log(f"  {label}: {int(it)} iterations, state bit-equal to the unsharded fused solve's: "
            f"{same}; {run.form} form, {run.replays} launch(es) "
            f"{run.replay_ms / max(int(it), 1):.3f} ms/iter")
        check(same, f"{label}: the final state differs from the unsharded fused solve's")
    finally:
        cache.clear()       # its keys hold the group
        dist.destroy_process_group()


def psd_phase(device, launches, by_shape, log):
    """Phase 8: ``psd_method`` "eigh" and "ladder" on every driver: the
    bridge at P=4 and the 64-robot cross coupled, each host-stepped
    (`psd_host_phase`) and fused (`fused_phase`, as phase 6), then
    `solve_fused_batch` at B = 16 (`psd_batch`) and the sharded fused solve
    of the cross with the ladder (`psd_sharded`)."""
    cases = psd_cases()
    host_rows = psd_host_phase(device, cases, launches, by_shape, log)
    fused_rows = fused_phase(device, cases, host_rows, launches, by_shape, log, select=False)
    for method in PSD_METHODS:
        psd_batch(device, method, launches, by_shape, log)
    psd_sharded(device, fused_rows[f"phase 8 u{FLEET} coupled ladder"]["state"], launches,
                by_shape, log)


# ---------------------------------------------------------------------------
# Phase 9: one congested step against float64 (tools/cuda_check.py)
# ---------------------------------------------------------------------------


def load_cuda_check():
    """This checkout's tools/cuda_check.py, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("cuda_check",
                                                  os.path.join(HERE, "tools", "cuda_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_check_phase(device, log):
    """Phase 9: `cuda_check.probe` on the card with each of its PSD methods:
    the 8-robot coupled cross warmed to its first congested step, the
    card's float32 direction, gnorm, planes and CCD limit against the CPU
    float64 oracle's, the post step's clearances and energy descent in
    float64, and the launches of the probe step.  Every entry must be ok
    (``kernels_active`` too)."""
    import torch

    cc = load_cuda_check()
    for method in cc.PSD_METHODS:
        r = cc.probe(device, torch.float32, psd_method=method,
                     log=lambda s, m=method: log(f"  {m}: {s}"))
        e = r["deviations"]
        log(f"  {method}: {r['device']}; warm iteration {r['warm_iter']}; newton_direction max "
            f"rel {e['newton_direction']['max_rel']:.3e} (tol {cc.DIRECTION_TOL}); dt "
            f"{e['time_direction']['card']:.9g} / f64 {e['time_direction']['cpu_f64']:.9g}; gnorm "
            f"{e['gnorm']['card']:.9g} / f64 {e['gnorm']['cpu_f64']:.9g}; planes "
            f"{e['n_planes']['card']} / f64 {e['n_planes']['cpu_f64']}; ccd step "
            f"{e['ccd_refine_active']['card_ccd_step']:.9g} / f64 "
            f"{e['ccd_refine_active']['cpu_f64_ccd_step']:.9g}")
        log(f"  {method}: post step clearance obstacle "
            f"{e['post_step_feasible']['min_obstacle_clearance']:.9g}, pair "
            f"{e['post_step_feasible']['min_pair_clearance']:.9g} (offset "
            f"{e['post_step_feasible']['offset']}); energy f64 warm "
            f"{e['post_step_descent']['e_warm_f64']:.12g}, post "
            f"{e['post_step_descent']['e_post_f64']:.12g}; launches in the probe step "
            f"{e['kernels_active']['probe_step']}, in the direction "
            f"{e['kernels_active']['direction']}, in the oracle {e['kernels_active']['oracle']}; "
            f"seconds {json.dumps({k: round(v, 3) for k, v in r['seconds'].items()})}")
        log(f"  {method}: " + json.dumps({k: v["ok"] for k, v in e.items()}))
        check(not r["failed"] and e["kernels_active"]["ok"] is True,
              f"phase 9 {method}: {r['failed']} failed: "
              + json.dumps({k: e[k] for k in r["failed"]}))


# ---------------------------------------------------------------------------
# Phase 5: timing
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


def captured(fn, reps=50):
    """``reps`` calls of ``fn`` captured in one CUDA graph (after a warm-up
    on a side stream), replayed once."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return graph


def device_ms(fn, reps=50):
    """Mean ms per call with the host out of the way: ``reps`` calls
    captured in one CUDA graph (`captured`), replayed between CUDA events
    (best of three replays).  Unlike `time_ms` it leaves out the host's
    cost of issuing each call, which at these sizes is longer than the
    kernels themselves; it keeps the card's gap between two kernels of a
    graph."""
    import torch

    graph = captured(fn, reps)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def k2_rounds(u, iters):
    """Support rounds each problem of K2 runs on ``u`` (it stops a problem
    once converged): the plain version's loop with a per-problem counter."""
    import torch
    from trajopt_tpu_torch.ops import geometry as geo

    n, m = u.shape[0], u.shape[1]
    rows = torch.arange(n, device=u.device)
    scale = torch.clamp(u.abs().amax(dim=(1, 2)), min=1e-30)
    us = u / scale[:, None, None]
    w = us[rows, torch.argmin((us * us).sum(-1), dim=1)][:, None, :].expand(n, 4, 3).clone()
    active = torch.zeros((n, 4), dtype=torch.bool, device=u.device)
    active[:, 0] = True
    tol = 100 * torch.finfo(u.dtype).eps
    done = torch.zeros(n, dtype=torch.bool, device=u.device)
    rounds = torch.zeros(n, dtype=torch.int64, device=u.device)
    for _ in range(iters):
        rounds += ~done
        v, n2, sub = geo._min_norm_simplex(w, active)
        scores = (us @ v[:, :, None])[..., 0]
        s = torch.argmin(scores, dim=-1)
        us_s = us[rows, s]
        stale = (active & (w == us_s[:, None, :]).all(-1)).any(-1)
        done = done | (scores[rows, s] >= n2 - tol * torch.clamp(n2, min=1.0)) | sub.all(-1) | stale
        free = torch.argmin(sub.to(torch.uint8), dim=-1)
        w_new = w.clone()
        w_new[rows, free] = us_s
        active_new = sub.clone()
        active_new[rows, free] = True
        w = torch.where(done[:, None, None], w, w_new)
        active = torch.where(done[:, None], active, active_new)
        if bool(done.all()):
            break
    return rounds


def bound_ms(nbytes, flops):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fw_bound(u, iters):
    """K5's bound for ``iters`` rounds on u [N, m, 3]: the input read once
    and dist, lb and v written once; 9m + 60 operations a round and 6m for
    the start (see `kernel_timings`)."""
    n, m = u.shape[0], u.shape[1]
    return bound_ms(u.numel() * 4 + n * 20, n * (iters * (9 * m + 60) + 6 * m))


def fw_group_sweep(u, iters):
    """K5's register tier on u with G = 1, 2, 4 and 8 lanes a problem
    (`cuda_gjk.gjk_diffset_group`): {G: device ms}, timed in the order 1,
    2, 4, 8, 8, 4, 2, 1, best of each G's two.  Each G's output must bracket-
    intersect the routed kernel's within 1e-5 x max|u| (the partial sums
    of v are taken in another order, so paths part after round one)."""
    import torch
    from trajopt_tpu_torch.ops import cuda_gjk

    ref = cuda_gjk.gjk_diffset(u, iters)
    scale = u.abs().amax(dim=(1, 2))
    best = {}
    for g in (1, 2, 4, 8, 8, 4, 2, 1):
        h = cuda_gjk.gjk_diffset_group(u, iters, g)
        gap = float((torch.maximum(h.lb - ref.dist, ref.lb - h.dist) / scale).max())
        check(gap <= 1e-5, f"K5 with G={g}: brackets {gap:.3g} x scale from the routed kernel's")
        ms = device_ms(lambda g=g: cuda_gjk.gjk_diffset_group(u, iters, g))
        best[g] = min(best.get(g, float("inf")), ms)
    return best


def fw_route_matrix(device, iters=32):
    """The measurement behind `cuda_gjk.fw_route`'s choice of G: K5's device
    ms with each G of `FW_ROUTE_G` that holds m (`gjk_diffset_group`), on
    random sets at m = 6, 12, 24, 36, 64 and n = 16 to 64512 problems, with
    the G the route takes.  [{m, n, device_ms: {G: ms}, routed}]"""
    import numpy as np
    from trajopt_tpu_torch.ops import cuda_gjk

    t = _f32(device)
    rng = np.random.default_rng(3)
    out = []
    for m in (6, 12, 24, 36, 64):
        for n in (16, 128, 1024, 8192, 64512):
            u = t(rng.normal(size=(n, m, 3)) + np.array([0.5, 0.2, -0.1]))
            gs = [g for g in cuda_gjk.FW_ROUTE_G if g <= m and -(-m // g) <= cuda_gjk.FW_VPL[g][-1]]
            times = {g: device_ms(lambda g=g: cuda_gjk.gjk_diffset_group(u, iters, g), 20) for g in gs}
            out.append(dict(m=m, n=n, device_ms=times, routed=cuda_gjk.fw_route(m, n).g))
    return out


def shape_timings(topk, gjk, fw=(), plain_of=()):
    """K1, K2 and K5 at every case of `topk_cases`, `gjk_cases` and
    `fw_cases` (call-site shapes and edge cases): ms per call (`time_ms`;
    best of kernel, library, library, kernel, or of two for K2 and K5), ms
    from a CUDA graph (`device_ms`), the same two for
    `torch.topk(largest=False, sorted=True)` beside K1, each case's bound
    (as in `kernel_timings`), and plain ms for the cases named in
    ``plain_of``.  K5 is timed through `gjk_diffset(u, iters)` alone; a
    port whose K5 takes m <= FW_MAX_M only (before the route by m) gets
    "refused (m > FW_MAX_M)" for the larger shapes.  Only the wrappers'
    call signatures are used, so ``--time-shapes`` runs it on another
    checkout's port as well."""
    import torch
    from trajopt_tpu_torch.ops import cuda_gjk, cuda_topk

    rows = []
    for name, x, k in topk:
        n = x.shape[-1]
        kern = lambda x=x, k=k: cuda_topk.smallest_k(x, k)
        lib = lambda x=x, k=k: torch.topk(x, k, largest=False, sorted=True)
        t = [time_ms(kern), time_ms(lib), time_ms(lib), time_ms(kern)]
        bound, by = bound_ms(x.numel() * 4 + x.numel() // n * k * 12, x.numel())
        rows.append(dict(kernel="smallest_k", case=name, n=n, k=k, ms=min(t[0], t[3]),
                         device_ms=device_ms(kern), library_ms=min(t[1], t[2]),
                         library_device_ms=device_ms(lib), bound_ms=bound, bound_by=by))
        if name in plain_of:
            plain = lambda x=x, k=k: cuda_topk.smallest_k_plain(x, k)
            rows[-1]["plain_ms"] = min(time_ms(plain), time_ms(plain))
    for name, u, iters, _ in gjk:
        n, m = u.shape[0], u.shape[1]
        kern = lambda u=u, iters=iters: cuda_gjk.gjk_exact(u, iters)
        rounds = int(k2_rounds(u, iters).sum())
        bound, by = bound_ms(u.numel() * 4 + n * 20, rounds * (760 + 8 * m))
        rows.append(dict(kernel="gjk_exact", case=name, n=n, m=m, ms=min(time_ms(kern), time_ms(kern)),
                         device_ms=device_ms(kern), library_ms=None, library_device_ms=None,
                         rounds=rounds, bound_ms=bound, bound_by=by))
        if name in plain_of:
            plain = lambda u=u, iters=iters: cuda_gjk.gjk_exact_plain(u, iters)
            rows[-1]["plain_ms"] = min(time_ms(plain, 5), time_ms(plain, 5))
    cap = getattr(cuda_gjk, "FW_MAX_M", None)
    route = getattr(cuda_gjk, "fw_route", None)
    for name, _, u, iters, _ in fw:
        n, m = u.shape[0], u.shape[1]
        bound, by = fw_bound(u, iters)
        row = dict(kernel="gjk_fw", case=name, n=n, m=m, iters=iters, bound_ms=bound, bound_by=by,
                   library_ms=None, library_device_ms=None,
                   route=None if route is None else list(route(m, n)))
        if cap is not None and m > cap:
            rows.append(dict(row, ms=None, device_ms=None, refused=f"refused (m > {cap})"))
            continue
        kern = lambda u=u, iters=iters: cuda_gjk.gjk_diffset(u, iters)
        rows.append(dict(row, ms=min(time_ms(kern), time_ms(kern)), device_ms=device_ms(kern)))
    return rows


def chol_callsite_inputs(device):
    """(blocks h, right-hand sides b or None[, gmw]) at every call-site shape
    of K3, K4 and the fused kernel in the single P=4 and the 64-robot solves:
    the PSD repair's [4,19,19] and [64,4,19,19], the slack Newton step's
    [4,19,19] with b [4,19] and [256,19,19] with b [256,19], the KKT's
    [33,33] and [64,33,33] with b [.,33,2] (factor and solve) and b [.,33]
    (refinement).  Positive-definite blocks, made from a seed.  Last, the
    ``eigh`` slack step's fused launches with ``gmw=False`` at [4,19,19]
    and [256,19,19] (`eigh_blocks`), then phase 7's own inputs
    (`batch_chol_timing_inputs`)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32, device=device)

    def spd(*shape):
        a = rng.normal(size=shape)
        return torch.as_tensor(a @ np.swapaxes(a, -1, -2) + shape[-1] * np.eye(shape[-1]), **f32)

    def vec(*shape):
        return torch.as_tensor(rng.normal(size=shape), **f32)

    h4, h256, k1, k64 = spd(4, 19, 19), spd(256, 19, 19), spd(33, 33), spd(FLEET, 33, 33)
    return [(h4, None), (spd(FLEET, 4, 19, 19), None), (h4, vec(4, 19)), (h256, vec(256, 19)),
            (k1, vec(33, 2)), (k64, vec(FLEET, 33, 2)), (k1, vec(33)), (k64, vec(FLEET, 33))] + [
        (h, b, False) for _, h, b in eigh_blocks(device, 5)] + batch_chol_timing_inputs(device)


def _digest(*tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def latency_floor(device):
    """Device ms (`device_ms`) of an empty kernel and of one dependent step
    shaped like K3's (warp max, division, square root, division, shuffle,
    multiply-add) and like K4's (division, shuffle, multiply-add), from the
    one-warp probe of ``csrc/chol.cu`` at 0 and at 4096 steps.  A
    latency-bound factorization of an m x m block cannot take less than
    empty + m K3 steps, a solve less than empty + 2m K4 steps."""
    import torch
    from trajopt_tpu_torch.ops import cuda_chol

    out = torch.zeros(64, dtype=torch.float32, device=device)
    steps = 4096
    floor = {"empty_ms": device_ms(lambda: cuda_chol.latency_probe(out, 0, 3))}
    for kind in (3, 4):
        long = device_ms(lambda: cuda_chol.latency_probe(out, steps, kind))
        floor[f"k{kind}_step_ms"] = (long - floor["empty_ms"]) / steps
    return floor


def chol_shape_timings(inputs, floor=None, library=True):
    """K3, K4 and (where the port has it) the fused kernel at every case of
    `chol_callsite_inputs`: ms per call (`time_ms`, best of two), device ms
    (`device_ms`), busy ms (the kernel's own time under torch.profiler,
    `device_busy_share`), the library call's ms per call beside K3
    (`torch.linalg.cholesky_ex`), K4 (`torch.cholesky_solve`; MAGMA, not
    capturable) and the fused kernel with ``gmw=False`` (`torch.linalg.solve`,
    also busy: it syncs), the bound, the latency floor (`latency_floor`) and a digest
    of the outputs, by which two checkouts' kernels are compared bit for
    bit.  Only `mod_chol(h)`, `chol_solve(l, b)` and `factor_solve(h, b[,
    gmw=False])` are called, so ``--time-shapes`` runs it on another
    checkout's port."""
    import torch
    from trajopt_tpu_torch.ops import cuda_chol

    def dims(t):
        return "[" + ",".join(map(str, t.shape)) + "]"

    def row(kernel, case, m, kern, lib, nbytes, flops, steps3, steps4, out, lib_busy=False):
        bound, by = bound_ms(nbytes, flops)
        r = dict(kernel=kernel, case=case, m=m, ms=min(time_ms(kern), time_ms(kern)),
                 device_ms=device_ms(kern), library_ms=None, bound_ms=bound, bound_by=by,
                 digest=_digest(*out))
        if library:
            r["busy_ms"] = device_busy_share(kern, 20)[0] / 20
            if lib is not None:
                r["library_ms"] = min(time_ms(lib), time_ms(lib))
            if lib_busy:
                r["library_busy_ms"] = device_busy_share(lib, 20)[0] / 20
        if floor is not None:
            r["floor_ms"] = (floor["empty_ms"] + steps3 * floor["k3_step_ms"]
                             + steps4 * floor["k4_step_ms"])
        return r

    rows, factored = [], set()
    for h, b, *gmw in inputs:
        m = h.shape[-1]
        n = h.numel() // (m * m)
        flops3 = n * (2 * m ** 3 / 3 + 2 * m ** 2)
        if gmw and not gmw[0]:
            k = 1 if b.ndim == h.ndim - 1 else b.shape[-1]
            # x of a PD block (the "eigh" slack step takes x alone, want_l=False):
            # one PyTorch call computes it, torch.linalg.solve, which syncs
            rows.append(row("factor_solve", f"{dims(h)} b={dims(b)} gmw=False", m,
                            lambda h=h, b=b: cuda_chol.factor_solve(h, b, gmw=False),
                            lambda h=h, b=b: torch.linalg.solve(h, b),
                            2 * h.numel() * 4 + n * m * 4 + 2 * b.numel() * 4,
                            flops3 + n * k * 2 * m ** 2, m, 2 * m,
                            cuda_chol.factor_solve(h, b, gmw=False), lib_busy=True))
            continue
        l, e = cuda_chol.mod_chol(h)
        if id(h) not in factored:
            factored.add(id(h))
            rows.append(row("mod_chol", dims(h), m, lambda h=h: cuda_chol.mod_chol(h),
                            lambda h=h: torch.linalg.cholesky_ex(h),
                            2 * h.numel() * 4 + n * m * 4, flops3, m, 0, (l, e)))
        if b is None:
            continue
        k = 1 if b.ndim == h.ndim - 1 else b.shape[-1]
        bm = b[..., None] if b.ndim == h.ndim - 1 else b
        flops4 = n * k * 2 * m ** 2
        case = f"{dims(h)} b={dims(b)}"
        x = cuda_chol.chol_solve(l, b)
        rows.append(row("chol_solve", case, m, lambda l=l, b=b: cuda_chol.chol_solve(l, b),
                        lambda l=l, bm=bm: torch.cholesky_solve(bm, l),
                        l.numel() * 4 + 2 * b.numel() * 4, flops4, 0, 2 * m, (x,)))
        if hasattr(cuda_chol, "factor_solve"):
            rows.append(row("factor_solve", case, m,
                            lambda h=h, b=b: cuda_chol.factor_solve(h, b), None,
                            2 * h.numel() * 4 + n * m * 4 + 2 * b.numel() * 4, flops3 + flops4,
                            m, 2 * m, cuda_chol.factor_solve(h, b)))
    return rows


def large_kkt_timings(device):
    """What the P >= 8 reduced KKT (ns > 64, here ns = 141 of P = 16) pays
    per call: `kkt._factor_block_tridiag` (a loop over 18 x 18 blocks of
    `solve_triangular`, matmuls and K3 in plain mode) and the block-by-block
    `solve_triangular` substitutions of `kkt._factor_solve` with two
    right-hand sides, for one system and for 64.  ms per call between CUDA
    events (host issue included)."""
    import numpy as np
    import torch
    from trajopt_tpu_torch.ops import kkt

    rng = np.random.default_rng(4)
    ns, out = 141, {}
    band = np.abs(np.arange(ns)[:, None] - np.arange(ns)[None, :]) < 18
    for n in (1, FLEET):
        a = rng.normal(size=(n, ns, ns))
        a = (a @ a.transpose(0, 2, 1)) * band + 4 * ns * np.eye(ns)
        a = torch.as_tensor(a, dtype=torch.float32, device=device)
        b = torch.as_tensor(rng.normal(size=(n, ns, 2)), dtype=torch.float32, device=device)
        l = kkt._factor_block_tridiag(a)
        check(bool(torch.isfinite(l).all()), "block-tridiagonal factor of a PD system is not finite")
        factor = lambda a=a: kkt._factor_block_tridiag(a)
        solve = lambda l=l, b=b: kkt._factor_solve(l, b)
        out[f"[{n},{ns},{ns}]"] = dict(factor_ms=min(time_ms(factor, 20), time_ms(factor, 20)),
                                       solve_ms=min(time_ms(solve, 20), time_ms(solve, 20)))
    return out


def kernel_timings(device, pair_diffs, rows):
    """Per kernel at one 64-robot slice shape.  ms: per call between CUDA
    events (`time_ms`; kernel, plain, plain, kernel, each one's best).
    device ms: from a CUDA graph (`device_ms`), without the host's cost of
    issuing each call, which at these sizes is longer than K1, K2 and K4
    themselves.  plain ms: CUDA events.  library ms: the one PyTorch call
    computing the same function, per call (None where there is none);
    library device ms from a CUDA graph for `torch.topk` only, because the
    MAGMA batched solvers behind `cholesky_solve` abort under capture.  For
    K3 and K4 and their library calls, busy ms instead: the kernels' own
    device time per call under torch.profiler (`device_busy_share`), the
    same method for both.  bound ms: the least time the card could take.
    K1 and K2 are the `HEADLINE` rows of `shape_timings`.

    Operation counts, from the sources: K1 one compare per input element;
    K2 (760 + 8m) flops per support round (Gram matrix, 15 subset solves,
    scoring) times the rounds each problem runs; K3 2m^3/3 + 2m^2 per
    block; K4 2m^2 per right-hand side per block; K5 only what Frank-Wolfe
    needs, 9m + 60 operations a round (5m for the scores u.v, m each for the
    argmin and the argmax, 2m for the weight update, and O(1) for the two
    line searches, whose trial points v + g(u_s - v) and v + g(u_s - u_a)
    and their norms have closed forms, and for lb) plus 6m for the start
    (norms and their argmin)."""
    import numpy as np
    import torch
    from trajopt_tpu_torch.ops import cuda_chol, cuda_gjk

    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=device)
    a = rng.normal(size=(256, 19, 19))
    h = torch.as_tensor(a @ a.transpose(0, 2, 1) + 19 * np.eye(19), **f32)
    k = rng.normal(size=(FLEET, 33, 33))
    kkt = torch.as_tensor(k @ k.transpose(0, 2, 1) + 33 * np.eye(33), **f32)
    l33 = cuda_chol.mod_chol(kkt)[0]
    rhs = torch.as_tensor(rng.normal(size=(FLEET, 33, 2)), **f32)
    fa = pair_diffs.shape

    out = {}
    for name, case in HEADLINE.items():
        row = next(r for r in rows if r["kernel"] == name and r["case"] == case)
        out[name] = dict(row, shape=case.split(" ", 2)[-1])
    cases = {
        "gjk_fw": (f"{list(fa)} iters=32", lambda: cuda_gjk.gjk_diffset(pair_diffs, 32),
                   lambda: cuda_gjk.gjk_fw_plain(pair_diffs, 32), None, fw_bound(pair_diffs, 32)),
        "mod_chol": ("[256,19,19]", lambda: cuda_chol.mod_chol(h),
                     lambda: cuda_chol.mod_chol_plain(h),
                     lambda: torch.linalg.cholesky_ex(h),
                     bound_ms(2 * h.numel() * 4 + 256 * 19 * 4, 256 * (2 * 19 ** 3 / 3 + 2 * 19 ** 2))),
        "chol_solve": ("L [64,33,33], b [64,33,2]", lambda: cuda_chol.chol_solve(l33, rhs),
                       lambda: cuda_chol.chol_solve_plain(l33, rhs),
                       lambda: torch.cholesky_solve(rhs, l33),
                       bound_ms(l33.numel() * 4 + 2 * rhs.numel() * 4, FLEET * 2 * 2 * 33 ** 2)),
        # no one PyTorch call factors with the GMW pivot rule and solves
        "factor_solve": ("h [64,33,33], b [64,33,2]", lambda: cuda_chol.factor_solve(kkt, rhs),
                         lambda: cuda_chol.factor_solve_plain(kkt, rhs), None,
                         bound_ms(2 * kkt.numel() * 4 + FLEET * 33 * 4 + 2 * rhs.numel() * 4,
                                  FLEET * (2 * 33 ** 3 / 3 + 2 * 33 ** 2 + 2 * 2 * 33 ** 2))),
    }
    for name, (shape, kern, plain, library, (bound, bound_by)) in cases.items():
        reps_plain = 50 if name in ("mod_chol", "chol_solve") else 5
        k1 = time_ms(kern)
        p1 = time_ms(plain, reps_plain)
        p2 = time_ms(plain, reps_plain)
        k2 = time_ms(kern)
        lib = None if library is None else min(time_ms(library), time_ms(library))
        out[name] = dict(shape=shape, ms=min(k1, k2), device_ms=device_ms(kern),
                         plain_ms=min(p1, p2), library_ms=lib, library_device_ms=None,
                         bound_ms=bound, bound_by=bound_by)
        if library is not None:
            out[name]["busy_ms"] = device_busy_share(kern, 20)[0] / 20
            out[name]["library_busy_ms"] = device_busy_share(library, 20)[0] / 20
    return out


def eig_floor(device):
    """Device ms (`device_ms`) of an empty kernel and of one round of K6's
    design, from its probe (`cuda_eig.latency_probe`: one CUDA block running
    rounds shaped like K6's and nothing else) at 0 and at 4096 rounds.  A
    call whose blocks run side by side, the slowest taking R rounds, cannot
    take less than empty + R rounds."""
    import torch
    from trajopt_tpu_torch.ops import cuda_eig

    out = torch.zeros(64, dtype=torch.float32, device=device)
    steps = 4096
    empty = device_ms(lambda: cuda_eig.latency_probe(out, 0))
    long = device_ms(lambda: cuda_eig.latency_probe(out, steps))
    return {"empty_ms": empty, "round_ms": (long - empty) / steps}


def isolated_ms(fn, reps=20):
    """(least, median) ms of one call of ``fn`` between CUDA events, each
    queued behind a sleep on the card so that the host's cost of issuing it
    is hidden, the card otherwise idle."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in pairs)
    return ms[0], ms[len(ms) // 2]


def kernel_records(step, reps, name):
    """(device ms per call, records) of the kernels whose name holds ``name``
    under torch.profiler over ``reps`` calls of ``step()``: the records are
    how many launches the profiler returned (fewer than ``reps`` launches
    means it lost some, and the ms per call reads low with them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    us, records = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and name in evt.key:
            t = getattr(evt, "self_device_time_total", None)
            us += evt.self_cuda_time_total if t is None else t
            records += evt.count
    return us / 1e3 / reps, records


def graph_busy_ms(fn, reps=50):
    """The kernels' own device ms per call of ``fn`` under torch.profiler
    over one replay of the graph of `device_ms` (`captured`), beside
    `kernel_records`' eager calls."""
    return device_busy_share(captured(fn, reps).replay, 1)[0] / reps


def eig_shape_timings(inputs, library=True, floor=None):
    """K6 (`cuda_eig.eigvalsh`) at each (name, h) of ``inputs``: ms per call
    (`time_ms`; kernel, plain, plain, kernel, each one's best), device ms
    from 50 launches in one CUDA graph (`device_ms`), the least and median
    ms of one launch alone (`isolated_ms`), busy ms under torch.profiler for
    20 eager calls with the number of launches it recorded
    (`kernel_records`) and inside the graph (`graph_busy_ms`), the bound, the largest |w - w64| / |H|_F against
    float64 and a digest of the output (equal digests = bit-equal kernels).
    With ``library``: float32 `torch.linalg.eigvalsh`, the plain version and
    the one library call, per call and busy (it waits on the host for its
    error check, so no graph holds it).  With ``floor`` (`eig_floor`): the
    rounds K6 runs on these blocks (`testing.eig_kernel_model`, the largest
    and the mean), the latency floor empty + largest rounds x a round, and
    whether K6 gives the model's bits on every block.  Bound:
    max(bytes / 3.35 TB/s, (4/3) m^3 N / 67 TFLOP/s), the bytes h read and
    w written once.  Only `cuda_eig.eigvalsh` is called, so ``--time-shapes``
    runs it on another checkout's port."""
    import torch
    from trajopt_tpu_torch.ops import cuda_eig

    rows = []
    for name, h in inputs:
        m = h.shape[-1]
        n = h.numel() // (m * m)
        kern = lambda h=h: cuda_eig.eigvalsh(h)
        plain = lambda h=h: cuda_eig.eigvalsh_plain(h)
        t = [time_ms(kern), time_ms(plain), time_ms(plain), time_ms(kern)] if library else \
            [time_ms(kern), None, None, time_ms(kern)]
        bound, by = bound_ms(h.numel() * 4 + n * m * 4, n * 4 * m ** 3 / 3)
        alone, alone_median = isolated_ms(kern)
        busy, records = kernel_records(kern, 20, "eigvalsh_kernel")
        w = kern()
        hd = h.reshape(-1, m, m).double().cpu()
        err = float(((w.reshape(-1, m).double().cpu() - torch.linalg.eigvalsh(hd)).abs().amax(-1)
                     / torch.linalg.matrix_norm(hd).clamp(min=1e-30)).max())
        row = dict(kernel="eigvalsh", case=name, shape=_dims((h,)), m=m, n=n,
                   ms=min(t[0], t[3]), device_ms=device_ms(kern), isolated_ms=alone,
                   isolated_median_ms=alone_median, busy_ms=busy, busy_records=records,
                   graph_busy_ms=graph_busy_ms(kern), bound_ms=bound, bound_by=by,
                   err_over_fro=err, digest=_digest(w))
        if library:
            row.update(plain_ms=min(t[1], t[2]), library_ms=min(t[1], t[2]),
                       library_busy_ms=device_busy_share(plain, 20)[0] / 20,
                       library_device_ms=None)
        if floor is not None:
            from trajopt_tpu_torch.testing import eig_kernel_model, eig_padded

            model_w, sweeps = eig_kernel_model(h)
            rounds = sweeps.reshape(-1) * (eig_padded(m) - 1)
            row.update(rounds_max=int(rounds.max()), rounds_mean=float(rounds.double().mean()),
                       floor_ms=floor["empty_ms"] + int(rounds.max()) * floor["round_ms"],
                       model_bit_equal=bool(((model_w == w) | (model_w.isnan() & w.isnan())).all()))
        rows.append(row)
    return rows


SLACK_TIMED = ("1x4", "64x4", "1024x4")   # testing.SLACK_CASES: [4|256|4096,19,19]
SLACK_HEADLINE = "64x4"                    # the 64-robot cross's slack phase


def slack_timings(device):
    """`slack_step` at the solver's slack shapes (`SLACK_TIMED`: one UAV of
    P = 4, the 64-robot cross, the B = 1024 batch): ms per call between
    CUDA events (kernel, plain, plain, kernel, each one's best), device ms
    from 50 launches in one CUDA graph, the plain version's ms per call
    (`admm.slack_update_plain` on the card outside a graph: its ladder
    stages are host branches) and the bound.  Bytes: every input read once
    (the spline's rows, piece indices, conversion matrices, M, piece times,
    slacks and duals) and every output written once; operations: per piece
    the Hessian (19 x 19), K3's factor (2m^3/3 + 2m^2) and K4's solve
    (4m^2), and 300 a trial energy for e0 and the rungs up to the accepted
    one.  No one PyTorch call computes the phase.  [row]"""
    import torch
    from trajopt_tpu_torch import testing
    from trajopt_tpu_torch.ops import cuda_slack
    from trajopt_tpu_torch.solver import admm

    rows = []
    for case in (c for c in testing.SLACK_CASES if c[0] in SLACK_TIMED):
        name, robots, pieces, ks, edge = case
        consts, cfg, state = testing.slack_case(robots, pieces, ks, edge)
        consts, state = (type(x)(*(t.to(device=device, dtype=torch.float32)
                                   if t.is_floating_point() else t.to(device) for t in x))
                         for x in (consts, state))
        kern = lambda: cuda_slack.slack_step(consts, cfg, state)
        plain = lambda: admm.slack_update_plain(consts, cfg, state)
        rungs = kern()[2]
        n, m = state.t_slack.numel(), 19
        nbytes = (state.spline.numel() + consts.convert.numel() + consts.m_dyn.numel()
                  + state.piece_time.numel() + 2 * (state.p_slack.numel() + n)) * 4 \
            + consts.piece_idx.numel() * 8 + (2 * (state.p_slack.numel() + n) + robots + n) * 4
        flops = n * (m * m + 2 * m ** 3 / 3 + 2 * m ** 2 + 4 * m ** 2) \
            + 300 * (2 * n + int(rungs.sum()))
        bound, by = bound_ms(nbytes, flops)
        k1, p1, p2, k2 = time_ms(kern), time_ms(plain, 5), time_ms(plain, 5), time_ms(kern)
        rows.append(dict(shape=f"[{n},19,19]", case=name, ms=min(k1, k2),
                         device_ms=device_ms(kern), plain_ms=min(p1, p2), library_ms=None,
                         library_device_ms=None, bound_ms=bound, bound_by=by,
                         busy_ms=device_busy_share(kern, 20)[0] / 20))
    return rows


def psd_timings(device):
    """K6 at each solver call shape of `psd_call_inputs` (`eig_shape_timings`,
    with its latency floor, `eig_floor`) and K3's plain mode at each of the
    ladder's trial shapes; returns (rows, K6's floor).  ms: per call between CUDA events (kernel, library,
    library, kernel, each one's best); device ms: 50 launches in one CUDA
    graph; busy ms: the kernels' own time per call under torch.profiler.
    Beside K3, `torch.linalg.cholesky_ex`; bound as in `kernel_timings`,
    L and e written."""
    import torch
    from trajopt_tpu_torch.ops import cuda_chol

    calls = psd_call_inputs(device)
    floor = eig_floor(device)
    rows = eig_shape_timings([(name, args[0]) for name, args, _ in calls["eigvalsh"]], floor=floor)
    for name, h in ladder_trials(calls):
        m = h.shape[-1]
        n = h.numel() // (m * m)
        kern = lambda h=h: cuda_chol.mod_chol(h, gmw=False)
        lib = lambda h=h: torch.linalg.cholesky_ex(h)
        t = [time_ms(kern), time_ms(lib), time_ms(lib), time_ms(kern)]
        bound, by = bound_ms(2 * h.numel() * 4 + n * m * 4, n * (2 * m ** 3 / 3 + 2 * m ** 2))
        rows.append(dict(kernel="mod_chol gmw=False", case=name, shape=_dims((h,)), m=m, n=n,
                         ms=min(t[0], t[3]), device_ms=device_ms(kern),
                         busy_ms=device_busy_share(kern, 20)[0] / 20,
                         library_ms=min(t[1], t[2]),
                         library_busy_ms=device_busy_share(lib, 20)[0] / 20,
                         bound_ms=bound, bound_by=by))
    return rows, floor


def time_other_port(port, out_path):
    """``--time-shapes``: `shape_timings` (K1, K2 and K5), `chol_shape_timings` (with
    the digests of K3's and K4's outputs) and `eig_shape_timings` (K6 at the
    solver's call shapes of `psd_call_inputs`, with its error against
    float64 and its digest) of the port in checkout ``port`` on this
    checkout's inputs, written as one JSON object to ``out_path`` (stdout if
    None), after `check_gjk_paths` on its K2 (logged to stderr).
    The inputs are made with this checkout's package, which is then
    unloaded so that ``port``'s is imported in its place.  To compare two
    commits on one card, run parent, change, change, parent in one call."""
    import numpy as np
    import torch

    device = torch.device("cuda", 0)
    pair_diffs = fleet_pair_diffs(device)
    rng = np.random.default_rng(2)
    topk, gjk = topk_cases(device, rng), gjk_cases(device, rng, pair_diffs)
    fw = fw_cases(device, rng, pair_diffs)
    chol = chol_callsite_inputs(device)
    eig = [(name, args[0]) for name, args, _ in psd_call_inputs(device)["eigvalsh"]]
    for mod in [m for m in sys.modules if m.split(".")[0] == "trajopt_tpu_torch"]:
        del sys.modules[mod]
    sys.path.insert(0, os.path.abspath(port))
    import trajopt_tpu_torch
    from trajopt_tpu_torch.ops import cuda_gjk

    for name, u, iters, n_brute in gjk:
        if n_brute is None:
            check_gjk_paths(name, u, iters, cuda_gjk.gjk_exact(u, iters), cuda_gjk.gjk_exact_plain(u, iters),
                            u.abs().amax(dim=(1, 2)), lambda line: print(line, file=sys.stderr, flush=True))
    text = json.dumps({"package": os.path.dirname(trajopt_tpu_torch.__file__),
                       "card": nvidia_smi_line(),
                       "rows": shape_timings(topk, gjk, fw) + chol_shape_timings(chol, library=False)
                       + eig_shape_timings(eig, library=False)})
    if out_path is None:
        print(text)
    else:
        with open(out_path, "w") as f:
            f.write(text + "\n")
    return 0


def time_fused_calls(port, out_path):
    """``--time-calls``: four whole calls of each of phase 6's fused solves
    (`fused_cases`, full size) by the port in checkout ``port``: from the
    start, from `moved_start`, from the start again, and from the start
    after `cache.clear()` (where ``port`` has the graph cache: a miss with
    no other graph held).  Each call's row: its
    whole-call ms (the 2 final reads included), launch ms (`graph.LAST_RUN`),
    iterations, warm-up, capture and instantiation ms, graph pool bytes and
    whether it hit the graph cache (None where ``port`` has no such
    field).  One short call of another key first pays the process's
    first-capture costs.  Written as one JSON object to ``out_path``
    (stdout if None).  To compare two commits on one card, run parent,
    change, change, parent in one call."""
    import torch

    sys.path.insert(0, os.path.abspath(port))
    import trajopt_tpu_torch
    from trajopt_tpu_torch.runtime import graph

    try:
        from trajopt_tpu_torch.runtime import cache
    except ImportError:             # a port that captures at every call
        cache = None
    device = torch.device("cuda", 0)
    rows = []
    for i, case in enumerate(fused_cases()):
        cfg, _, _, consts, scene, state0 = case.build(device)
        max_iters = MAX_ITERS if case.coupled is None else FLEET_MAX_ITERS
        if i == 0:
            _fused_solve(consts, cfg, scene, state0, case.coupled, 2)
        calls = []
        for n, start in enumerate((state0, moved_start(state0), state0, state0)):
            if n == 3 and cache is not None:
                cache.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, it, gnorm = _fused_solve(consts, cfg, scene, start, case.coupled, max_iters)
            it, gnorm = int(it), float(gnorm)
            whole_ms = (time.perf_counter() - t0) * 1e3
            run = graph.LAST_RUN
            calls.append({"iters": it, "whole_ms": whole_ms, "launch_ms": run.replay_ms,
                          "warmup_ms": run.warmup_ms, "capture_ms": run.capture_ms,
                          **{key: getattr(run, key, None)
                             for key in ("instantiate_ms", "pool_bytes", "hit")}})
        rows.append({"case": case.label, "calls": calls})
        print(f"{case.label}: " + "; ".join(
            f"{c['iters']} it, whole {c['whole_ms'] / c['iters']:.3f} ms/it, launch "
            f"{c['launch_ms'] / c['iters']:.3f}, hit {c['hit']}" for c in calls),
            file=sys.stderr, flush=True)
    text = json.dumps({"package": os.path.dirname(trajopt_tpu_torch.__file__),
                       "card": nvidia_smi_line(), "rows": rows})
    if out_path is None:
        print(text)
    else:
        with open(out_path, "w") as f:
            f.write(text + "\n")
    return 0


def shape_counts(names=SOLVE_KERNELS + ("eigvalsh", "slack_step")):
    """{kernel: {call shape: launches}} since the last reset of the counts."""
    from trajopt_tpu_torch.ops import _cuda

    out = {name: {} for name in names}
    for (name, shape), c in _cuda.LAUNCH_SHAPES.items():
        if name in out:
            out[name][_cuda.shape_label(shape)] = c
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke test of trajopt_tpu_torch.")
    ap.add_argument("--time-shapes", metavar="DIR",
                    help="only time the K1, K2, K5, K3, K4 and K6 of the checkout DIR at every "
                         "timed shape (this checkout's inputs) and print them as JSON")
    ap.add_argument("--time-calls", metavar="DIR",
                    help="only time four whole calls of each of phase 6's fused drivers by the "
                         "checkout DIR's port and print them as JSON")
    ap.add_argument("--out", metavar="FILE",
                    help="with --time-shapes or --time-calls: write the JSON to FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "trajopt_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    if args.time_shapes:
        return time_other_port(args.time_shapes, args.out)
    if args.time_calls:
        return time_fused_calls(args.time_calls, args.out)
    from trajopt_tpu_torch.config import TrajOptConfig
    from trajopt_tpu_torch.ops import _cuda

    log = lambda s: print(s, flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_t = [t_start]

    def phase_done(n):
        now = time.perf_counter()
        log(f"-- phase {n}: {now - phase_t[0]:.1f} s")
        phase_t[0] = now

    # -- phase 1 ------------------------------------------------------------
    log("== phase 1: card and build")
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    _cuda.lib()
    log(f"kernel build: {_cuda.build_info['seconds']:.2f} s (cached={_cuda.build_info['cached']})")
    from trajopt_tpu_torch.ops import cuda_cond

    runtime, driver_version = cuda_cond.versions()
    log(f"CUDA runtime of the kernel library {runtime}, driver {driver_version}: an IF/ELSE is "
        + ("one IF node with an ELSE body" if cuda_cond.if_else_nodes() else "two IF nodes"))
    for line in ptxas_report(_cuda.build_info["log"]):
        log("  ptxas: " + line)
    phase_done(1)

    # -- phase 2 ------------------------------------------------------------
    log("== phase 2: kernels against their plain versions (float32, on the card)")
    pair_diffs = fleet_pair_diffs(device)
    errs = check_kernels(device, log, pair_diffs=pair_diffs)
    phase_done(2)

    # -- phase 3 ------------------------------------------------------------
    log("== phase 3: single-UAV bridge solves (float32, on the card)")
    launches, by_shape, host_rows = {}, {}, {}
    for pieces in SLICE_PIECES:
        _cuda.reset_launches()
        row = solve_case(pieces, device, torch.float32)
        torch.cuda.synchronize()
        launches[f"single p{pieces}"] = dict(_cuda.LAUNCHES)
        by_shape[f"single p{pieces}"] = shape_counts()
        log(f"  p{pieces}: iters {row['iters']}, gnorm {row['gnorm']:.4g}, "
            f"ccd_time {row['ccd_time']:.4f}, ccd_len {row['ccd_len']:.4f}, "
            f"min clearance {row['min_clearance']:.4f}, median {row['median_iter_ms']:.2f} ms/iter, "
            f"solve {row['solve_s']:.2f} s, launches {launches[f'single p{pieces}']}")
        log(f"    launches by call shape: {by_shape[f'single p{pieces}']}")
        check_path_launches(f"p{pieces}", launches[f"single p{pieces}"],
                            *path_kernels(TrajOptConfig(), None, pieces))
        check_parity(f"p{pieces}", row, reference_row("single", pieces=pieces), log)
        host_rows[f"single p{pieces}"] = row
        if pieces == SLICE_PIECES[0]:
            card_iters = row["iters"]
            card_rows = {"default": row}
    cpu = solve_case(SLICE_PIECES[0], torch.device("cpu"), torch.float64)
    log(f"  p{SLICE_PIECES[0]} CPU float64: iters {cpu['iters']}, gnorm {cpu['gnorm']:.4g}, "
        f"ccd_time {cpu['ccd_time']:.4f}, ccd_len {cpu['ccd_len']:.4f}")
    gap = abs(cpu["iters"] - card_iters)
    check(gap <= ITER_SLACK, f"card and CPU float64 iteration counts differ by {gap}")
    log_syncs(f"steady p{SLICE_PIECES[0]} (the second from the start)",
              single_steady_syncs(SLICE_PIECES[0], device), log)
    option_launches, option_shapes = single_options_phase(device, card_rows, log)
    launches.update(option_launches)
    by_shape.update(option_shapes)
    phase_done(3)

    # -- phase 4 ------------------------------------------------------------
    log(f"== phase 4: {FLEET}-robot cross, coupled and decoupled (float32, on the card)")
    fleet_launches, fleet_rows, fleet_shapes = fleet_phase(device, log)
    launches.update(fleet_launches)
    by_shape.update(fleet_shapes)
    host_rows.update({f"u{FLEET} {mode}": r for mode, r in fleet_rows.items()})
    fleet_launches, fleet_shapes, host_rows[f"u{FLEET} coupled optimal_plane"] = \
        optimal_fleet_phase(device, log)
    launches.update(fleet_launches)
    by_shape.update(fleet_shapes)
    phase_done(4)


    # -- phase 5 ------------------------------------------------------------
    log(f"== phase 5: kernel, plain, library and bound times ({smi}); ms per call between "
        "CUDA events, device ms from 50 launches in one CUDA graph")
    import numpy as np
    from trajopt_tpu_torch.ops import cuda_chol, cuda_gjk, cuda_topk

    rng = np.random.default_rng(2)
    rows = shape_timings(topk_cases(device, rng), gjk_cases(device, rng, pair_diffs),
                         fw_cases(device, rng, pair_diffs), plain_of=set(HEADLINE.values()))
    times = kernel_timings(device, pair_diffs, rows)
    for name, tm in times.items():
        lib = "none" if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms per call" + (
            "" if tm["library_device_ms"] is None else f" ({tm['library_device_ms']:.4f} device)")
        busy = "" if "busy_ms" not in tm else \
            f"; busy (torch.profiler) kernel {tm['busy_ms']:.4f}, library {tm['library_busy_ms']:.4f} ms"
        log(f"  {name} {tm['shape']}: kernel {tm['ms']:.4f} ms per call ({tm['device_ms']:.4f} "
            f"device), plain {tm['plain_ms']:.4f} ms, library {lib}, bound {tm['bound_ms']:.5f} ms "
            f"({tm['bound_by']}){busy}")
    k1 = times["smallest_k"]
    log(f"  K1 / torch.topk at {k1['shape']}: per call {k1['ms']:.4f} / {k1['library_ms']:.4f} ms "
        f"= {k1['ms'] / k1['library_ms']:.2f}; device {k1['device_ms']:.4f} / "
        f"{k1['library_device_ms']:.4f} ms = {k1['device_ms'] / k1['library_device_ms']:.2f}")
    log("  K1, K2 and K5 at every case of phase 2 (ms per call / device ms; bound):")
    for r in rows:
        if r["kernel"] == "smallest_k":
            log(f"    K1 {r['case']} route {cuda_topk.route(r['n'], r['k'])}: kernel "
                f"{r['ms']:.4f} / {r['device_ms']:.4f}, torch.topk {r['library_ms']:.4f} / "
                f"{r['library_device_ms']:.4f}, bound {r['bound_ms']:.5f} ({r['bound_by']})")
        elif r["kernel"] == "gjk_exact":
            log(f"    K2 {r['case']}: kernel {r['ms']:.4f} / {r['device_ms']:.4f}, bound "
                f"{r['bound_ms']:.5f} ({r['bound_by']}, {r['rounds']} support rounds)")
        else:
            tier, g, vpl = r["route"]
            log(f"    K5 {r['case']} {r['iters']} rounds, route {tier} G={g} VPL={vpl}: kernel "
                f"{r['ms']:.4f} / {r['device_ms']:.4f}, bound {r['bound_ms']:.5f} ({r['bound_by']})")
    sweep = fw_group_sweep(pair_diffs, 32)
    log(f"  K5 G sweep at {list(pair_diffs.shape)} x 32 rounds, device ms by lanes a problem: "
        + ", ".join(f"G={g} {ms:.4f}" for g, ms in sweep.items())
        + f" (routed: G={cuda_gjk.fw_route(pair_diffs.shape[1], pair_diffs.shape[0]).g})")
    matrix = fw_route_matrix(device)
    log("  K5 device ms by lanes a problem G, random sets x 32 rounds (the route's G marked *):")
    for r in matrix:
        best = min(r["device_ms"].values())
        log(f"    m={r['m']} n={r['n']}: " + ", ".join(
            f"G={g}{'*' if g == r['routed'] else ''} {ms:.4f}" for g, ms in r["device_ms"].items())
            + f"; routed / fastest {r['device_ms'][r['routed']] / best:.2f}")
    floor = latency_floor(device)
    log(f"  latency probe (device ms): empty kernel {floor['empty_ms']:.5f}, one K3-like step "
        f"{floor['k3_step_ms']:.6f}, one K4-like step {floor['k4_step_ms']:.6f}")
    log("  K3, K4 and the fused kernel at every call-site shape (ms per call / device ms, busy ms "
        "under torch.profiler; library ms per call; bound; latency floor = empty + m K3 steps + 2m K4 steps):")
    chol_rows = chol_shape_timings(chol_callsite_inputs(device), floor)
    for r in chol_rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}" + (
            f" (busy {r['library_busy_ms']:.4f}, torch.linalg.solve)" if "library_busy_ms" in r else "")
        log(f"    {r['kernel']} {r['case']}, route {cuda_chol.route(r['m'])}: kernel {r['ms']:.4f} / "
            f"{r['device_ms']:.4f} (busy {r['busy_ms']:.4f}), library {lib}, bound {r['bound_ms']:.5f} ({r['bound_by']}), "
            f"floor {r['floor_ms']:.5f} ({r['device_ms'] / r['floor_ms']:.2f}x), digest {r['digest']}")
    for shape, tm in large_kkt_timings(device).items():
        log(f"  P=16 KKT {shape}, ms per call: block-tridiagonal factor "
            f"{tm['factor_ms']:.4f}, block solve with 2 right-hand sides {tm['solve_ms']:.4f}")
    log("  K6 at the solver's call shapes and K3's plain mode at the shift ladder's (ms per call "
        "/ device ms, busy ms under torch.profiler; beside K6 float32 torch.linalg.eigvalsh, its "
        "plain version and the library call, beside K3 torch.linalg.cholesky_ex: ms per call, "
        "busy ms; bound; for K6 one launch alone (least / median), busy inside the graph, the "
        "rounds of its slowest block by testing.eig_kernel_model and the latency floor = empty + "
        "those rounds x one round of its probe):")
    psd_rows, floor_eig = psd_timings(device)
    for r in psd_rows:
        eig = "" if "floor_ms" not in r else (
            f"; {r['busy_records']} of 20 launches recorded; alone {r['isolated_ms']:.4f} / "
            f"{r['isolated_median_ms']:.4f}, graph busy "
            f"{r['graph_busy_ms']:.4f}; rounds {r['rounds_max']} (mean {r['rounds_mean']:.1f}), "
            f"floor {r['floor_ms']:.5f} ({r['device_ms'] / r['floor_ms']:.2f}x); max |w - w64| / "
            f"|H|_F {r['err_over_fro']:.2e}, the model's bits {r['model_bit_equal']}, digest "
            f"{r['digest']}")
        log(f"    {r['kernel']} {r['case']}: kernel {r['ms']:.4f} / {r['device_ms']:.4f} (busy "
            f"{r['busy_ms']:.4f}), library {r['library_ms']:.4f} (busy {r['library_busy_ms']:.4f}), "
            f"bound {r['bound_ms']:.5f} ({r['bound_by']}){eig}")
    log(f"  K6 probe (device ms): empty kernel {floor_eig['empty_ms']:.5f}, one round "
        f"{floor_eig['round_ms']:.6f}")
    times["eigvalsh"] = next(r for r in psd_rows if r["kernel"] == "eigvalsh"
                             and r["shape"] == EIG_HEADLINE)
    slack_rows = slack_timings(device)
    log("  slack_step at the solver's slack shapes (ms per call / device ms, busy ms under "
        "torch.profiler; the plain version's ms per call; bound):")
    for r in slack_rows:
        log(f"    slack_step {r['shape']} ({r['case']}): kernel {r['ms']:.4f} / "
            f"{r['device_ms']:.4f} (busy {r['busy_ms']:.4f}), plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']})")
    times["slack_step"] = next(r for r in slack_rows if r["case"] == SLACK_HEADLINE)
    sc = times["set_condition"] = set_condition_timings(device)
    log(f"  set_condition: one device_cond node (set_condition, an IF/ELSE node, one-element "
        f"sides) {sc['ms']:.5f} ms a node in a chain of 50 in one graph (the select form's "
        f"link {sc['select_ms']:.5f}); the kernel {sc['device_ms']:.5f} ms (mean of "
        f"{sc['records']} profiler records); plain (host read of the predicate) "
        f"{sc['plain_ms']:.4f} ms per call; bound {sc['bound_ms']:.2e} ms ({sc['bound_by']})")
    phase_done(5)

    # -- phase 6 ------------------------------------------------------------
    log(f"== phase 6: the fused drivers, each solve one CUDA graph replayed (float32, on the "
        f"card; {smi})")
    fused_rows = fused_phase(device, fused_cases(), host_rows, launches, by_shape, log)
    phase_done(6)

    # -- phase 7 ------------------------------------------------------------
    log(f"== phase 7: scenario batches and sharding (float32, on the card; {smi})")
    batch_single_phase(device, launches, by_shape, log)
    fleet_batch_phase(device, launches, by_shape, log)
    sharding_phase(device, fused_rows, launches, by_shape, log)
    phase_done(7)

    # -- phase 8 ------------------------------------------------------------
    log(f"== phase 8: every PSD repair on every driver (float32, on the card; {smi})")
    psd_phase(device, launches, by_shape, log)
    phase_done(8)

    # -- phase 9 ------------------------------------------------------------
    log(f"== phase 9: a congested 8-robot coupled step against the CPU float64 oracle "
        f"(tools/cuda_check.py; float32, on the card; {smi})")
    step_check_phase(device, log)
    phase_done(9)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    path = {name: f"u{FLEET} coupled" for name in KERNELS}
    path["gjk_fw"] = f"u{FLEET} coupled pair clearance"
    path["eigvalsh"] = f"phase 8 u{FLEET} coupled eigh"
    path["set_condition"] = f"u{FLEET} coupled fused"
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        tm = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[path[name]][name], "max_abs_err": errs[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"], "shape": tm["shape"],
            "device_ms": tm["device_ms"], "library_device_ms": tm["library_device_ms"],
            **{key: tm[key] for key in ("busy_ms", "library_busy_ms") if key in tm},
            "launches_by_path": {p: c[name] for p, c in launches.items()},
        })
        if name != "gjk_fw":
            kernels[-1]["launches_by_shape"] = {p: c[name] for p, c in by_shape.items() if name in c}
        shapes = [r for r in chol_rows if r["kernel"] == name]
        if shapes:
            kernels[-1]["by_call_shape"] = shapes
            kernels[-1]["latency_floor"] = floor
        if name == "mod_chol":
            kernels[-1]["gmw_false_by_call_shape"] = [r for r in psd_rows
                                                      if r["kernel"] == "mod_chol gmw=False"]
        if name == "eigvalsh":
            kernels[-1]["by_call_shape"] = [r for r in psd_rows if r["kernel"] == name]
            kernels[-1]["latency_floor"] = floor_eig
        if name == "slack_step":
            kernels[-1]["by_call_shape"] = slack_rows
        if name == "gjk_fw":
            kernels[-1]["by_call_shape"] = [r for r in rows if r["kernel"] == name]
            kernels[-1]["group_sweep_device_ms"] = sweep
            kernels[-1]["route_matrix"] = matrix
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
