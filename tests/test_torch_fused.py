"""The torch port's fused single-UAV driver and the device control flow under
it, on the CPU in float64: `solve_fused` against the JAX package's, every
fused driver against the port's host-stepped one bit for bit, every step
body in the select form (`runtime.graph.select_form`, which a graph of
straight-line kernels holds: the fused loop's ``form="select"`` and the
warm-up before each capture) without a host sync and bit-equal to the
branch form, every `device_cond` site driven both ways (the steps with ``psd_method="eigh"``
and ``"ladder"`` too), and the P >= 8 KKT against the JAX package's.  The
fused multi-robot drivers against JAX are in tests/test_torch_fused_multi.py,
every fused driver with each PSD repair in tests/test_torch_psd.py."""

import ast
import collections
import dataclasses
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from trajopt_tpu import types as jt
from trajopt_tpu.config import TrajOptConfig
from trajopt_tpu.ops import kkt as jkkt
from trajopt_tpu.ops import splines as jsp
from trajopt_tpu.scenes import generators as jgen
from trajopt_tpu.solver import driver as jdriver
from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import cuda_eig, cuda_gjk, kkt
from trajopt_tpu_torch.ops import splines as sp
from trajopt_tpu_torch.runtime import graph
from trajopt_tpu_torch.scenes import generators as gen
from trajopt_tpu_torch.solver import admm, driver, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
PKG = pathlib.Path(__file__).resolve().parent.parent / "trajopt_tpu_torch"

WAYPOINTS = np.array([[-3.0, 0.0, 0.0], [-1.0, 1.7, 0.0], [1.0, 1.7, 0.0], [3.0, 0.0, 0.0]])


def port_cfg(cfg, **changes):
    """The port's TrajOptConfig with the JAX one's fields."""
    return tconfig.TrajOptConfig(**{**dataclasses.asdict(cfg), **changes})


def _close(got, want, rtol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1e-300))


def single_problem(**options):
    """Res 2, 3 pieces around a sphere of 200 points (the port's side)."""
    cfg = tconfig.TrajOptConfig(res=2, max_planes=8, max_ccd_candidates=8, **options)
    ops = sp.build_spline_ops(len(WAYPOINTS) - 1, cfg.res)
    cloud = gen.sphere_scene(n_points=200, radius=1.0, seed=1)
    return (cfg, tt.device_consts(ops, **F64), tt.make_scene(cloud, **F64),
            tt.init_state(ops, WAYPOINTS, cfg.init_piece_time, **F64))


def fleet_problem(obstacles=True, gap=0.15, **options):
    """Two robots crossing at right angles, ``gap`` apart vertically, res 2,
    2 pieces; with ``obstacles`` a sphere of 200 points 0.12 from the first
    robot's path, else 8 points far away."""
    cfg = tconfig.TrajOptConfig(res=2, max_planes=4, max_self_planes=2, max_ccd_candidates=4,
                                ks=1e-3, **options)
    t = np.linspace(0, 1, 3)[:, None]
    wps = [np.array([-3.0, 0, 0]) * (1 - t) + np.array([3.0, 0, 0]) * t,
           np.array([0, -3.0, gap]) * (1 - t) + np.array([0, 3.0, gap]) * t]
    ops = sp.build_spline_ops(2, cfg.res)
    cloud = (gen.sphere_scene(200, radius=0.3, center=(1.5, 0.42, 0.0)) if obstacles
             else np.full((8, 3), 100.0))
    return (cfg, tt.device_consts(ops, **F64), tt.make_scene(cloud, **F64),
            multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64))


# ---------------------------------------------------------------------------
# solve_fused against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_single():
    cfg = TrajOptConfig(res=2, max_planes=8, max_ccd_candidates=8)
    ops = jsp.build_spline_ops(len(WAYPOINTS) - 1, cfg.res)
    # strongly typed copy of the initial state (same values): init_state's
    # weakly typed t_slack would make JAX compile the loop a second time
    state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                         jt.init_state(ops, WAYPOINTS, cfg.init_piece_time))
    cloud = jgen.sphere_scene(n_points=200, radius=1.0, seed=1)
    return cfg, jt.device_consts(ops), jt.make_scene(cloud), state


@pytest.mark.parametrize("stop, max_iters", [(0.0, 5), (float("inf"), 5), (None, 80)],
                         ids=["stop0", "stop_inf", "default_stop"])
def test_solve_fused_matches_jax(jax_single, stop, max_iters):
    """The same iteration count, spline and piece time to rtol 1e-8, gnorm
    to rtol 1e-6.  ``stop=0`` runs all 5 iterations; ``stop=inf`` exactly
    2 (the ``it <= 1`` clause); the default stop converges before 80."""
    cfg, jc, jscene, jstate = jax_single
    if stop is not None:
        cfg = dataclasses.replace(cfg, stop=stop)
    jfinal, jit_, jgnorm = jdriver.solve_fused(jc, cfg, jstate, jscene, max_iters=max_iters)
    conv = lambda x: tt.from_numpy(x, **F64)
    state, it, gnorm = driver.solve_fused(conv(jc), port_cfg(cfg), conv(jstate), conv(jscene),
                                          max_iters=max_iters)
    assert it.dtype == torch.int64 and it.shape == () and gnorm.shape == ()
    assert int(it) == int(jit_)
    if stop == float("inf"):
        assert int(it) == 2
    elif stop == 0.0:
        assert int(it) == max_iters
    else:
        assert int(it) < max_iters and float(gnorm) < cfg.stop
    _close(state.spline, jfinal.spline, 1e-8)
    _close(state.piece_time, jfinal.piece_time, 1e-8)
    _close(gnorm, jgnorm, 1e-6)


def test_solve_fused_with_no_iteration_returns_the_start():
    """``max_iters=0``: no step, iterations 0 and gnorm +inf in the state's
    dtype, as the JAX loop's initial carry."""
    cfg, consts, scene, state0 = single_problem()
    state, it, gnorm = driver.solve_fused(consts, cfg, state0, scene, max_iters=0)
    assert int(it) == 0 and gnorm.dtype == torch.float64 and float(gnorm) == float("inf")
    assert all(torch.equal(a, b) for a, b in zip(state, state0))


# ---------------------------------------------------------------------------
# fused against host-stepped, bit for bit
# ---------------------------------------------------------------------------


def _host_and_fused(kind):
    """(host-stepped final state, its iterations, its last gnorm, fused
    result) for 7 iterations at most."""
    if kind == "single":
        cfg, consts, scene, state0 = single_problem()
        state, hist = driver.solve(consts, cfg, state0, scene, max_iters=7, validate_init=False)
        return state, len(hist), hist[-1]["gnorm"], driver.solve_fused(consts, cfg, state0, scene,
                                                                         max_iters=7)
    options = dict(optimal_plane=True) if kind == "cached" else {}
    cfg, consts, scene, state0 = fleet_problem(**options)
    coupled = kind != "decoupled"
    state, hist = driver.solve_multi(consts, cfg, state0, scene, coupled=coupled, max_iters=7)
    if kind == "cached":
        caches = multi.init_multi_caches(cfg, consts, 2, **F64)
        fused = driver.solve_fused_multi_cached(consts, cfg, state0, scene, True, caches,
                                                max_iters=7)[:3]
    else:
        fused = driver.solve_fused_multi(consts, cfg, state0, scene, coupled, max_iters=7)
    return state, len(hist), hist[-1]["gnorm"], fused


@pytest.mark.parametrize("steps_per_replay", [None, 3], ids=["module_K", "K3"])
@pytest.mark.parametrize("kind", ["single", "coupled", "decoupled", "cached"])
def test_fused_equals_host_stepped(monkeypatch, kind, steps_per_replay):
    """The fused driver runs the host-stepped driver's step function under
    the reference's loop condition: at ``max_iters=7`` (not a multiple of a
    3-step block) the same iterations and a bit-equal state."""
    if steps_per_replay is not None:
        monkeypatch.setattr(graph, "STEPS_PER_REPLAY", steps_per_replay)
    host, n_iters, last_gnorm, (state, it, gnorm) = _host_and_fused(kind)
    assert int(it) == n_iters
    assert float(gnorm) == last_gnorm
    for a, b in zip(state, host):
        assert torch.equal(a, b)
    assert graph.LAST_RUN.replays == -(-n_iters // graph.STEPS_PER_REPLAY)


# ---------------------------------------------------------------------------
# the select form: no host sync, bit-equal to the branch form
# ---------------------------------------------------------------------------

_SYNCS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.is_nonzero.default,
          torch.ops.aten.nonzero.default}


class NoHostSync(TorchDispatchMode):
    """Raises on the ops that read a tensor on the host: `.item()`,
    `bool()` and `float()` reach `_local_scalar_dense` (through
    `is_nonzero` for `bool`), and `nonzero` sizes its output on the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _SYNCS:
            raise AssertionError(f"host sync in the select form: {func}")
        return func(*args, **(kwargs or {}))


def _kernel_stand_in(plain):
    """A plain version stands in for its kernel on the CPU and runs outside
    the no-sync mode: K2's early exit reads a flag on the host, which the
    kernel does not; and K6's, `torch.linalg.eigvalsh`, takes another LAPACK
    path under a dispatch mode (eigenvectors too; other last bits), where
    the kernel computes the same either way."""
    def run(*args):
        with _disable_current_modes():
            return plain(*args)
    return run


def _site():
    """``file:function`` of the code that called `device_cond` (through
    `fixed_rounds` for a bounded loop)."""
    frame = sys._getframe(2)
    while frame.f_code.co_name == "fixed_rounds":
        frame = frame.f_back
    return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_code.co_name}"


def _run_selected(fn, seen):
    """``fn()`` in the select form under `NoHostSync`, recording the value
    each `device_cond` predicate took by site into ``seen``."""
    cond = graph.device_cond

    def recording(pred, true_fn, false_fn, *operands):
        with _disable_current_modes():
            seen[_site()].add(bool(pred))
        return cond(pred, true_fn, false_fn, *operands)

    patches = [(graph, "device_cond", recording),
               (cuda_gjk, "gjk_exact_plain", _kernel_stand_in(cuda_gjk.gjk_exact_plain)),
               (cuda_eig, "eigvalsh_plain", _kernel_stand_in(cuda_eig.eigvalsh_plain))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, value in patches:
            setattr(mod, name, value)
        with graph.select_form(), NoHostSync():
            return fn()
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _assert_equal_trees(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _bodies():
    """Step bodies, each a list of (label, step callable, advance): every
    case is a start state along a solve, chosen so that together they drive
    each predicate both ways: no obstacle candidate (the far cloud) and
    live ones, the CCD plateau and level 3, Armijo accept and the ladder,
    robots out of each other's plane radius.  ``advance`` gives the next
    start from the branch form's result."""
    out = {}
    cfg, consts, scene, state = single_problem()
    out["single"] = (lambda st: admm.admm_step(consts, cfg, st, scene), state, 12)
    # the spline blocks are indefinite from the fifth step on
    for method in ("eigh", "ladder"):
        pcfg = cfg.replace(psd_method=method)
        out[f"single_{method}"] = (lambda st, c=pcfg: admm.admm_step(consts, c, st, scene), state, 7)
    ocfg, oconsts, oscene, ostate = single_problem(optimal_plane=True)
    out["single_optimal_plane"] = (lambda st: admm.admm_step(oconsts, ocfg, st, oscene), ostate, 4)
    for coupled, name in ((True, "coupled"), (False, "decoupled")):
        for obstacles, gap in ((True, 0.15), (False, 3.0)):
            mcfg, mconsts, mscene, mstate = fleet_problem(obstacles=obstacles, gap=gap)
            key = f"{name}_{'obstacles' if obstacles else 'apart'}"
            out[key] = (lambda st, c=mconsts, g=mcfg, s=mscene, cp=coupled:
                        multi.multi_admm_step(c, g, st, s, cp), mstate, 8 if obstacles else 2)
    ccfg, cconsts, cscene, cstate = fleet_problem(optimal_plane=True)
    caches = multi.init_multi_caches(ccfg, cconsts, 2, **F64)
    out["cached"] = (lambda st, ca: multi.multi_admm_step_cached(cconsts, ccfg, st, cscene, True, ca),
                     (cstate, caches), 4)
    # two fleets of the crossing pair, the second 0.3 higher, as one
    # grouped fleet (`_coupled_grouped_update`'s gate reads both ways)
    gcfg, gconsts, gscene, gstate = fleet_problem()
    lift = torch.tensor([0.0, 0.0, 0.3], dtype=torch.float64)
    gstate = tt.SolverState(*(torch.cat([x, x]) for x in gstate))
    gstate = gstate._replace(spline=torch.cat([gstate.spline[:2], gstate.spline[2:] + lift]))
    for coupled, name in ((True, "grouped_coupled"), (False, "grouped_decoupled")):
        out[name] = (lambda st, cp=coupled: multi.multi_admm_step(gconsts, gcfg, st, gscene, cp,
                                                                  groups=2), gstate, 8)
    # three single UAVs sharing the sphere, as a scenario batch
    bcfg, bconsts, bscene, bstate = single_problem()
    bstate = tt.SolverState(*(torch.stack([x, x, x]) for x in bstate))
    bstate = bstate._replace(spline=bstate.spline + torch.tensor([0.0, 0.05, 0.1],
                                                                 dtype=torch.float64)[:, None, None])
    out["batch"] = (lambda st: multi.multi_admm_step(bconsts, bcfg, st, bscene, False,
                                                     interact=False), bstate, 6)
    return out


def _advance(result):
    """The next start from a step's result: the state, and for the cached
    body (state, caches)."""
    return (result[0], result[2]) if len(result) == 3 else result[0]


def _step(fn, start):
    return fn(*start) if isinstance(start, tuple) and not hasattr(start, "_fields") else fn(start)


_SEEN = {}


def _select_body(name):
    """Run body ``name`` from each of its starts in both forms; returns the
    sites seen (cached per process: the coverage test reuses them)."""
    if name in _SEEN:
        return _SEEN[name]
    seen = collections.defaultdict(set)
    if name == "ccd_conflict":
        _ccd_conflict(seen)
    elif name == "guard":
        _guard(seen)
    else:
        fn, start, n_steps = _bodies()[name]
        for _ in range(n_steps):
            want = _step(fn, start)
            got = _run_selected(lambda: _step(fn, start), seen)
            _assert_equal_trees(got, want)
            start = _advance(want)
    _SEEN[name] = dict(seen)
    return _SEEN[name]


def _ccd_conflict(seen):
    """Both fleet CCDs on two parallel robots 0.15 apart vertically moving
    into each other (directions +-0.5 in z): pair limits below the full
    step (no plateau, level 3 live), uncertified pairs and shrink rounds."""
    cfg, consts, scene, _ = fleet_problem(obstacles=False)
    t = np.linspace(0, 1, 3)[:, None]
    wps = [np.array([-3.0, 0, 0]) * (1 - t) + np.array([3.0, 0, 0]) * t]
    wps.append(wps[0] + np.array([0, 0, 0.15]))
    ops = sp.build_spline_ops(2, cfg.res)
    splines = multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64).spline
    directions = torch.zeros_like(splines)
    directions[0, :, 2], directions[1, :, 2] = 0.5, -0.5
    for fn in (multi.coupled_ccd_step, multi.decoupled_ccd_steps):
        want = fn(consts, cfg, splines, directions, scene)
        got = _run_selected(lambda: fn(consts, cfg, splines, directions, scene), seen)
        _assert_equal_trees(got, want)
        assert float(want.amin()) < 0.2


def _guard(seen):
    """The fused loop's guarded block at an active and at a finished carry."""
    cfg, consts, scene, state = single_problem()
    block = graph._block(driver.fused_step(consts, cfg, scene), 4, cfg.stop)
    for it in (0, 4):
        args = ((state,), torch.tensor(it), torch.tensor(float("inf"), dtype=torch.float64))
        want = block(*args)
        got = _run_selected(lambda: block(*args), seen)
        _assert_equal_trees(got, want)
        assert int(got[1]) == min(it + graph.STEPS_PER_REPLAY, 4)


BODIES = ["single", "single_eigh", "single_ladder", "single_optimal_plane", "coupled_obstacles",
          "coupled_apart", "decoupled_obstacles", "decoupled_apart", "cached", "grouped_coupled",
          "grouped_decoupled", "batch", "ccd_conflict", "guard"]


@pytest.mark.parametrize("body", BODIES)
def test_select_form_step_has_no_host_sync(body):
    """Each step body in the select form, which a straight-line CUDA graph
    holds, finishes under `NoHostSync` and equals the branch form's step bit for
    bit, from every start of the body."""
    assert _select_body(body)


def _device_cond_sites():
    """``file:function`` of every `graph.device_cond` and `graph.fixed_rounds`
    call in the port's package (outside `runtime/graph.py`), and of the
    fused loop's guard."""
    sites = {"graph.py:block"}
    for path in PKG.rglob("*.py"):
        if path.name == "graph.py":
            continue
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("device_cond", "fixed_rounds")):
                    # the innermost function holding the call names the site
                    inner = [f for f in ast.walk(fn) if isinstance(f, ast.FunctionDef)
                             and f is not fn and node in ast.walk(f)]
                    if not inner:
                        sites.add(f"{path.name}:{fn.name}")
    return sites


def test_every_device_cond_site_is_driven_both_ways():
    """Across the select-form cases every site of the package's device
    control flow takes both sides; none is left undriven."""
    seen = collections.defaultdict(set)
    for body in BODIES:
        for site, values in _select_body(body).items():
            seen[site] |= values
    sites = _device_cond_sites()
    assert len(sites) == 13, sorted(sites)
    assert {s: seen.get(s, set()) for s in sites} == {s: {False, True} for s in sites}


# ---------------------------------------------------------------------------
# the P >= 8 KKT (ns = 141) against the JAX package
# ---------------------------------------------------------------------------


def _banded_spd(p, rng):
    """SPD matrix with the solver's sparsity (tests/test_kkt.py)."""
    ns = 9 * p - 3
    a = np.zeros((ns, ns))
    for i in range(p):
        lo, hi = max(0, 9 * i - 6), min(ns, 9 * i + 12)
        blk = rng.standard_normal((hi - lo, hi - lo))
        a[lo:hi, lo:hi] += blk @ blk.T + 0.1 * np.eye(hi - lo)
    return a


def test_block_tridiagonal_kkt_matches_jax_at_p16():
    """Factor (K3's plain mode on the 18 x 18 blocks) and block solve at
    ns = 141 against `trajopt_tpu/ops/kkt.py` to rtol 1e-10, batched, with
    one and two right-hand sides; a non-PD block gives NaN where JAX's
    does (the block's lower triangle and every block after it)."""
    rng = np.random.default_rng(0)
    a = _banded_spd(16, rng)
    ab = np.stack([a, 2.0 * a])
    b = rng.standard_normal((2, 141, 2))
    jl = np.asarray(jkkt._factor_block_tridiag(jnp.asarray(ab)))
    tl = kkt._factor_block_tridiag(torch.as_tensor(ab))
    _close(tl, jl, 1e-10)
    _close(kkt._factor_solve(tl, torch.as_tensor(b)),
           jkkt._factor_solve(jnp.asarray(jl), jnp.asarray(b)), 1e-10)
    _close(kkt._factor_solve(tl, torch.as_tensor(b[..., 0])),
           jkkt._factor_solve(jnp.asarray(jl), jnp.asarray(b[..., 0])), 1e-10)
    for pos in (0, 40, 140):
        bad = a.copy()
        bad[pos, pos] = -50.0
        jl = np.asarray(jkkt._factor_block_tridiag(jnp.asarray(bad)))
        tl = kkt._factor_block_tridiag(torch.as_tensor(bad)).numpy()
        np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
        assert np.isnan(jl).any()
        np.testing.assert_allclose(np.nan_to_num(tl), np.nan_to_num(jl), rtol=1e-10, atol=1e-12)
