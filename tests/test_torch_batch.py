"""The torch port's scenario-batch paths against the JAX package on the CPU in
float64: `multi_admm_step` with ``groups=2`` (coupled and decoupled) and with
``interact=False``, `solve_fused_batch` and `solve_fused_batch_multi`, each
also against the port's own per-scenario (per-fleet) solves; the grouped
Armijo ladder down both branches; and the fleets' even split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_batch_and_checkpoint import make_batch
from tests.test_torch_fused import _close, port_cfg
from tests.test_torch_fused_multi import jax_fleet
from trajopt_tpu.solver import driver as jdriver
from trajopt_tpu.solver import multi as jmulti
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.runtime import graph
from trajopt_tpu_torch.solver import admm, driver, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def _strong(tree):
    """A strongly typed copy (same values): the weakly typed t_slack of
    `init_state` would make JAX compile each function twice."""
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)


def _port(*jax_side):
    return [tt.from_numpy(x, **F64) for x in jax_side]


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def grouped_fleets(b=2):
    """``b`` fleets of tests/test_torch_fused_multi.py's two crossing robots
    past the sphere, each fleet's splines shifted by its own seeded 1e-3
    jitter, stacked [b, 2, ...] (JAX side)."""
    cfg, jc, jscene, jstate = jax_fleet()
    rng = np.random.default_rng(1)
    fleets = [jstate._replace(spline=jstate.spline + rng.normal(scale=1e-3, size=jstate.spline.shape))
              for _ in range(b)]
    return cfg, jc, jscene, _strong(_stack(fleets))


def _flat(tree):
    return jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), tree)


def single_batch(n=3):
    """tests/test_batch_and_checkpoint.py's scenarios (spheres of 128
    points, P=3, res 2), all in scenario 0's scene, stacked [n] (JAX side)."""
    cfg, _, jc, _, _, states, scenes = make_batch(n_scen=n)
    return cfg, jc, scenes[0], _strong(_stack(states))


# ---------------------------------------------------------------------------
# one step against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["coupled_groups2", "decoupled_groups2", "batch_interact_false"])
def test_batch_steps_match_jax(case):
    """Three steps from the start, state and StepDiag after each at rtol
    1e-8, as the existing step tests hold them."""
    if case == "batch_interact_false":
        cfg, jc, jscene, jstate = single_batch()
        options, coupled = dict(interact=False), False
    else:
        cfg, jc, jscene, jstate = grouped_fleets()
        jstate = _flat(jstate)
        options, coupled = dict(groups=2), case.startswith("coupled")
    consts, scene, state = _port(jc, jscene, jstate)
    tcfg = port_cfg(cfg)
    for _ in range(3):
        jstate, jdiag = jmulti.multi_admm_step_jit(jc, cfg, jstate, jscene, coupled, **options)
        state, diag = multi.multi_admm_step(consts, tcfg, state, scene, coupled, **options)
        for got, want in zip(tt.to_numpy(state), jstate):
            _close(got, want, 1e-8)
        for got, want in zip(tt.to_numpy(diag), jdiag):
            _close(got, want, 1e-8)


# ---------------------------------------------------------------------------
# the fused batch drivers against the JAX package and the per-scenario solves
# ---------------------------------------------------------------------------


def test_solve_fused_batch_matches_jax_and_each_scenario():
    """Six iterations of three scenarios: the JAX package's batch at rtol
    1e-8 (gnorm 1e-6), and each scenario's own `solve_fused` at rtol 1e-8
    (the budgets do not overflow, so pooling changes nothing)."""
    cfg, jc, jscene, jstates = single_batch()
    jout, jit_, jgnorm = jdriver.solve_fused_batch(jc, cfg, jstates, jscene, max_iters=6)
    consts, scene, states = _port(jc, jscene, jstates)
    tcfg = port_cfg(cfg)
    out, it, gnorm = driver.solve_fused_batch(consts, tcfg, states, scene, max_iters=6)
    assert it.dtype == torch.int64 and int(it) == int(jit_) == 6
    for got, want in zip(out, jout):
        _close(got, want, 1e-8)
    _close(gnorm, jgnorm, 1e-6)
    for i in range(3):
        ref, ref_it, _ = driver.solve_fused(consts, tcfg, tt.index(states, i), scene, max_iters=6)
        assert int(ref_it) == 6
        _close(out.spline[i], ref.spline.numpy(), 1e-8)
        _close(out.piece_time[i], ref.piece_time.numpy(), 1e-8)


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
def test_solve_fused_batch_multi_matches_each_fleet(coupled):
    """Three fleets of two robots, five iterations: [B, U] in and out, and
    each fleet equal to its own `solve_fused_multi` at rtol 1e-8 (no robot
    is held back by another fleet's); coupled also against the JAX
    package's batch at rtol 1e-8."""
    cfg, jc, jscene, jstates = grouped_fleets(3)
    consts, scene, states = _port(jc, jscene, jstates)
    tcfg = port_cfg(cfg)
    out, it, gnorm = driver.solve_fused_batch_multi(consts, tcfg, states, scene, coupled=coupled,
                                                    max_iters=5)
    assert out.spline.shape == states.spline.shape and int(it) == 5
    if coupled:
        jout, jit_, jgnorm = jdriver.solve_fused_batch_multi(jc, cfg, jstates, jscene,
                                                             coupled=True, max_iters=5)
        assert int(jit_) == 5
        for got, want in zip(out, jout):
            _close(got, want, 1e-8)
        _close(gnorm, jgnorm, 1e-6)
    for i in range(3):
        ref, _, _ = driver.solve_fused_multi(consts, tcfg, tt.index(states, i), scene, coupled,
                                             max_iters=5)
        _close(out.spline[i], ref.spline.numpy(), 1e-8)
        _close(out.piece_time[i], ref.piece_time.numpy(), 1e-8)


# ---------------------------------------------------------------------------
# the grouped Armijo, and the groups' even split
# ---------------------------------------------------------------------------


def _grouped_start():
    """Two fleets of the crossing pair, the second 0.3 higher: along the
    solve the fleets' step0 is accepted by both, and by one only."""
    cfg, jc, jscene, jstates = grouped_fleets()
    consts, scene, states = _port(jc, jscene, jstates)
    states = states._replace(spline=states.spline + torch.tensor([[[[0.0]]], [[[0.3]]]],
                                                                 dtype=torch.float64)
                             * torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64))
    flat = tt.SolverState(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in states))
    return port_cfg(cfg), consts, scene, flat


def test_grouped_armijo_takes_both_branches():
    """Along 10 grouped coupled steps the batch-global gate ``all(accept0)``
    reads true and false; forcing the ladder where it reads true gives the
    same state (its first rung is step0) and the same energy to 1e-12."""
    cfg, consts, scene, state = _grouped_start()
    cond = graph.device_cond

    def step(st, force=False):
        """One grouped step; returns it with the values the gate took."""
        took = set()

        def patched(pred, true_fn, false_fn, *ops):
            if true_fn.__qualname__.startswith("_coupled_grouped_update"):
                took.add(bool(pred))
                if force:
                    return false_fn(*ops)
            return cond(pred, true_fn, false_fn, *ops)

        graph.device_cond = patched
        try:
            return multi.multi_admm_step(consts, cfg, st, scene, True, groups=2), took
        finally:
            graph.device_cond = cond

    seen, forced = set(), 0
    for _ in range(10):
        (new, diag), took = step(state)
        seen |= took
        if took == {True}:
            (alt, alt_diag), _ = step(state, force=True)
            for a, b in zip(alt, new):
                assert torch.equal(a, b)
            _close(alt_diag.energy, diag.energy.numpy(), 1e-12)
            forced += 1
        state = new
    assert seen == {True, False} and forced > 0


def test_groups_must_divide_the_fleet():
    """U % groups != 0 raises ValueError up front (the JAX package fails
    late in a reshape, or masks wrongly in decoupled mode)."""
    cfg, consts, scene, state = _grouped_start()       # U = 4
    for coupled in (True, False):
        with pytest.raises(ValueError, match="groups=3"):
            multi.multi_admm_step(consts, cfg, state, scene, coupled, groups=3)
    with pytest.raises(ValueError, match="groups=3"):
        driver.solve_fused_multi(consts, cfg, state, scene, True, max_iters=2, groups=3)



# ---------------------------------------------------------------------------
# the Armijo test takes feasible trials only (a fix of the reference's)
# ---------------------------------------------------------------------------


def test_armijo_accepts_only_feasible_trials():
    """From an infeasible iterate (e0 = +inf) the reference's test accepts
    an infeasible trial (inf >= inf); `admm.armijo_ok` takes a feasible one
    only, and otherwise is the reference's inequality."""
    inf = float("inf")
    e0 = torch.tensor([inf, inf, 1.0, 1.0, 1.0], dtype=torch.float64)
    e = torch.tensor([inf, 5.0, inf, 0.5, 0.99999], dtype=torch.float64)
    ok = admm.armijo_ok(e0, torch.tensor(1.0, dtype=torch.float64), 1.0, e)
    assert ok.tolist() == [False, True, False, True, False]


def test_float32_batch_stays_finite_past_convergence():
    """bench_scale.py's jittered bridge scenarios 42 and 95 (2000 points,
    P=4, stop 0) in float32: with the reference's Armijo test (an infinite
    e0 passes every trial) their piece time collapses once rounding leaves
    an iterate infeasible, and the batch stops at a NaN mean gnorm after 26
    of 50 iterations on the CPU; here all 50 run and every state stays
    finite with a positive piece time."""
    from trajopt_tpu_torch.config import TrajOptConfig
    from trajopt_tpu_torch.ops import splines as sp
    from trajopt_tpu_torch.scenes import generators as gen

    f32 = dict(device="cpu", dtype=torch.float32)
    cfg = TrajOptConfig(ks=1e-8, max_planes=16, max_ccd_candidates=16, stop=0.0)
    cloud, wp = gen.bridge_scene(n_points=2000, seed=0, n_pieces=4)
    ops = sp.build_spline_ops(4, cfg.res)
    state = tt.init_state(ops, wp, cfg.init_piece_time, **f32)
    deltas = np.random.default_rng(0).normal(scale=1e-3, size=(1024,) + tuple(state.spline.shape))
    states = tt.stack([state] * 3)
    states = states._replace(spline=states.spline + torch.as_tensor(deltas[[0, 42, 95]], **f32))
    out, it, gnorm = driver.solve_fused_batch(tt.device_consts(ops, **f32), cfg, states,
                                              tt.make_scene(cloud, **f32), max_iters=50)
    assert int(it) == 50 and torch.isfinite(gnorm)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    assert bool((out.piece_time > 0).all())


@pytest.mark.slow
def test_jax_batch_meets_the_cpp_gate():
    """The JAX package on the CPU in float64 passes the C++ P=4 gate on the
    batch chip_smoke.py phase 7 (b) holds the card to: 16 bridge scenarios
    of phase 3's problem (20000 points), scenario 0 unjittered, the rest
    jittered as bench_scale.py does, default stop on the mean gnorm.  So the
    card is held to the C++ row, not to a JAX row (~1 min)."""
    import json
    import pathlib

    from trajopt_tpu import metrics as jmt
    from trajopt_tpu import types as jt
    from trajopt_tpu.config import TrajOptConfig
    from trajopt_tpu.ops import splines as jsp
    from trajopt_tpu.scenes import generators as jgen

    cfg = TrajOptConfig(ks=1e-8, max_planes=16, max_ccd_candidates=16)
    cloud, wp = jgen.bridge_scene(n_points=20000, seed=0, n_pieces=4)
    ops = jsp.build_spline_ops(4, cfg.res)
    state = _strong(jt.init_state(ops, wp, cfg.init_piece_time))
    deltas = np.random.default_rng(0).normal(scale=1e-3, size=(16,) + state.spline.shape)
    deltas[0] = 0.0
    states = _stack([state] * 16)
    states = states._replace(spline=states.spline + deltas)
    out, it, gnorm = jdriver.solve_fused_batch(jt.device_consts(ops), cfg, states,
                                               jt.make_scene(cloud), max_iters=2000)
    assert int(it) == 25 and float(gnorm) < cfg.stop
    root = pathlib.Path(__file__).resolve().parent.parent
    ref = next(c for c in json.loads((root / "tools/ref_baseline/results.json").read_text())["cases"]
               if c["mode"] == "single" and c.get("pieces") == 4)
    spline0, time0 = np.asarray(out.spline[0]), float(out.piece_time[0])
    stats = jmt.trajectory_stats(ops, spline0, time0)
    assert abs(stats["ccd_time"] - ref["ccd_time"]) <= 0.02 * ref["ccd_time"]
    assert abs(stats["ccd_len"] - ref["ccd_len"]) <= 0.02 * ref["ccd_len"]
    for i in range(16):
        assert jmt.min_curve_clearance(ops, np.asarray(out.spline[i]), cloud,
                                       float(out.piece_time[i])) >= cfg.offset
