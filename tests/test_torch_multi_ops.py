"""The torch port's multi-robot ops and K5's plain version against the JAX
package on the CPU, in float64 unless stated: the Frank-Wolfe GJK (against
the Pallas kernel in interpret mode and against the reference's
`point_hull_distance_fw`), the fleet broad phase, the fleet obstacle and
robot-pair planes, the robot-pair CCD, the plane offset Newton, the port's
copies of the JAX-free host modules and `from_numpy` on a fleet state.
Inputs come from numpy seeds and the tests/test_multi.py fixture."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_multi import make_problem
from trajopt_tpu import config as jconfig
from trajopt_tpu.ops import broadphase as jbp
from trajopt_tpu.ops import ccd as jccd
from trajopt_tpu.ops import energies as jen
from trajopt_tpu.ops import geometry as jgeo
from trajopt_tpu.ops import pallas_gjk as pg
from trajopt_tpu.ops import splines as jsp
from trajopt_tpu.scenes import generators as jgen
from trajopt_tpu.scenes import io as jio
from trajopt_tpu.solver import admm as jadmm
from trajopt_tpu.solver import multi as jmulti
from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import testing as kernel_cases
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import broadphase as bp
from trajopt_tpu_torch.ops import ccd, cuda_gjk
from trajopt_tpu_torch.ops import energies as en
from trajopt_tpu_torch.ops import geometry as geo
from trajopt_tpu_torch.ops import splines as tsp
from trajopt_tpu_torch.scenes import generators as tgen
from trajopt_tpu_torch.scenes import io as tio
from trajopt_tpu_torch.solver import admm, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def port_cfg(cfg):
    """The port's TrajOptConfig with the JAX one's fields."""
    return tconfig.TrajOptConfig(**dataclasses.asdict(cfg))


def _close(got, want, rtol=1e-10):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1e-300))


# ---------------------------------------------------------------------------
# K5: Frank-Wolfe GJK
# ---------------------------------------------------------------------------


@pytest.fixture
def interpret_mode():
    """Run the Pallas kernel in its interpreter, as tests/test_pallas_gjk.py."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


# Frank-Wolfe with the away step meets exact ties by construction: after an
# exact line search on an edge both ends score u.v = |v|^2, and rounding
# (sums taken in another order) picks the away vertex.  Two implementations
# therefore agree to rounding for one round only.  After more rounds each
# problem's [lb, dist] brackets must intersect and contain the exact
# distance, and the port's brackets must be as tight as the reference's
# (`_tightness_faults`, the test chip_smoke.py holds kernel K5 to), which
# the port's own one-round output must fail (PERF.md, K5).


def _exact(u):
    return geo.origin_simplex_dist(torch.as_tensor(np.asarray(u), **F64), 64).dist.numpy()


def _np(x):
    return (x.numpy() if torch.is_tensor(x) else np.asarray(x)).astype(np.float64)


def _assert_one_round_equal(got, want, u, tol):
    scale = np.abs(u).reshape(len(u), -1).max(1)
    for g, w in ((got.dist, want.dist), (got.lb, want.lb)):
        assert (np.abs(g.numpy() - np.asarray(w)) / scale).max() <= tol
    assert (np.abs(got.v.numpy() - np.asarray(want.v)).max(1) / scale).max() <= tol


def _tightness_faults(got, want, want_half, u, true, tol):
    """At the median, (dist - lb) / scale on the problems ``want`` certifies
    separated and (dist - exact) / scale may exceed twice ``want``'s by
    ``tol``; at the maximum, ``want_half``'s (half the rounds) by ``tol``."""
    scale = np.abs(u).reshape(len(u), -1).max(1)
    sep = _np(want.lb) > 1e-3 * scale

    def looseness(h):
        d = _np(h.dist)
        return {"dist-lb": ((d - _np(h.lb)) / scale)[sep], "dist-true": (d - true) / scale}

    faults = []
    ref, half = looseness(want), looseness(want_half)
    for key, k in looseness(got).items():
        if k.size and np.median(k) > 2.0 * np.median(ref[key]) + tol:
            faults.append(f"median {key}")
        if k.size and k.max() > half[key].max() + tol:
            faults.append(f"max {key}")
    return faults


def _assert_same_brackets(run_got, run_want, u, iters, tol):
    """``run_*(rounds) -> HullDist``: soundness and tightness after ``iters``
    rounds, and the one-round control (except at m = 1, where every round
    returns the one vertex)."""
    got, want = run_got(iters), run_want(iters)
    scale = np.abs(u).reshape(len(u), -1).max(1)
    g_lb, g_d = _np(got.lb), _np(got.dist)
    w_lb, w_d = _np(want.lb), _np(want.dist)
    assert (np.maximum(g_lb - w_d, w_lb - g_d) / scale).max() <= tol
    true = _exact(u)
    for lb, d in ((g_lb, g_d), (w_lb, w_d)):
        assert ((lb - true) / scale).max() <= tol
        assert ((true - d) / scale).max() <= tol
    want_half = run_want(iters // 2)
    assert _tightness_faults(got, want, want_half, u, true, tol) == []
    assert _tightness_faults(run_got(1), want, want_half, u, true, tol) or u.shape[1] == 1


@pytest.mark.parametrize("n,m", [(5, 6), (130, 12), (64, 36)])
def test_gjk_fw_plain_matches_pallas_kernel(interpret_mode, n, m):
    """float32, the shapes of tests/test_pallas_gjk.py, 1e-5 x max|u|."""
    rng = np.random.default_rng(n * 100 + m)
    u = rng.standard_normal((n, m, 3)).astype(np.float32) + np.array([0.5, 0.2, -0.1], np.float32)
    _assert_one_round_equal(cuda_gjk.gjk_diffset(torch.as_tensor(u), 1),
                            pg.gjk_diffset(jnp.asarray(u), iters=1), u, 1e-5)
    _assert_same_brackets(lambda k: cuda_gjk.gjk_diffset(torch.as_tensor(u), k),
                          lambda k: pg.gjk_diffset(jnp.asarray(u), iters=k), u, 32, 1e-5)


def test_gjk_pairs_and_points_match_pallas_kernel(interpret_mode):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((17, 6, 3)).astype(np.float32)
    b = (rng.standard_normal((17, 6, 3)) + np.array([4.0, 0, 0])).astype(np.float32)
    u = (a[:, :, None] - b[:, None]).reshape(17, 36, 3)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    _assert_one_round_equal(cuda_gjk.gjk_pairs(ta, tb, 1),
                            pg.gjk_pairs(jnp.asarray(a), jnp.asarray(b), iters=1), u, 1e-5)
    _assert_same_brackets(lambda k: cuda_gjk.gjk_pairs(ta, tb, k),
                          lambda k: pg.gjk_pairs(jnp.asarray(a), jnp.asarray(b), iters=k),
                          u, 32, 1e-5)
    verts = rng.standard_normal((9, 12, 3)).astype(np.float32)
    pts = rng.standard_normal((9, 3)).astype(np.float32)
    tv, tp = torch.as_tensor(verts), torch.as_tensor(pts)
    _assert_one_round_equal(cuda_gjk.gjk_points(tv, tp, 1),
                            pg.gjk_points(jnp.asarray(verts), jnp.asarray(pts), iters=1),
                            verts - pts[:, None], 1e-5)
    _assert_same_brackets(lambda k: cuda_gjk.gjk_points(tv, tp, k),
                          lambda k: pg.gjk_points(jnp.asarray(verts), jnp.asarray(pts), iters=k),
                          verts - pts[:, None], 24, 1e-5)


@pytest.mark.parametrize("iters", [8, 24, 32])
def test_gjk_fw_plain_matches_point_hull_distance_fw(iters):
    """float64: one round to rtol 1e-10, then the bracket contract."""
    rng = np.random.default_rng(iters)
    u = np.concatenate([
        rng.normal(size=(20, 12, 3)) + rng.normal(size=(20, 1, 3)) * 2.0,
        np.repeat(rng.normal(size=(6, 6, 3)), 2, axis=1),               # coincident
        rng.normal(size=(6, 12, 3)) * 0.3,                               # origin inside
    ])

    def ref(k):
        return jax.vmap(lambda d: jgeo.point_hull_distance_fw(d, jnp.zeros(3), k))(jnp.asarray(u))

    for g, w in zip(geo.gjk_fw_plain(torch.as_tensor(u, **F64), 1), ref(1)):
        _close(g, w)
    _assert_same_brackets(lambda k: geo.gjk_fw_plain(torch.as_tensor(u, **F64), k), ref,
                          u, iters, 1e-10)
    got = geo.gjk_fw_plain(torch.as_tensor(u, **F64), iters)
    # the objective never increases from round to round
    prev = geo.gjk_fw_plain(torch.as_tensor(u, **F64), iters - 1).dist
    assert (got.dist <= prev + 1e-12).all()


def test_hull_hull_distance_matches_jax():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(10, 6, 3)), rng.normal(size=(10, 6, 3)) + 1.5
    want = jax.vmap(lambda x, y: jgeo.hull_hull_distance(x, y, 48))(jnp.asarray(a), jnp.asarray(b))
    got = geo.hull_hull_distance(torch.as_tensor(a, **F64), torch.as_tensor(b, **F64), 48)
    for g, w in zip(got, want):
        _close(g, w)


# the edge sets on which chip_smoke.py holds K5 to its plain version on the
# card, one per route of `fw_route` and per tie rule: here the plain version
# is held to the Pallas kernel on the same inputs
_FW_EDGES = kernel_cases.fw_edge_sets(np.random.default_rng(kernel_cases.EDGE_SEED + 4))


def _edge_u(x):
    return x if not isinstance(x, tuple) else (x[0][:, :, None] - x[1][:, None]).reshape(
        len(x[0]), -1, 3)


@pytest.mark.parametrize("name,x,iters,n_brute", _FW_EDGES, ids=[c[0] for c in _FW_EDGES])
def test_gjk_fw_plain_edge_sets_match_pallas_kernel(interpret_mode, name, x, iters, n_brute):
    """float32: one round to 1e-5 x max|u|, then the bracket contract, and
    plain's brackets contain the brute-force distance on ``n_brute`` rows."""
    if isinstance(x, tuple):
        a, b = (c.astype(np.float32) for c in x)
        ours = lambda k: cuda_gjk.gjk_pairs(torch.as_tensor(a), torch.as_tensor(b), k)
        theirs = lambda k: pg.gjk_pairs(jnp.asarray(a), jnp.asarray(b), iters=k)
    else:
        a = x.astype(np.float32)
        ours = lambda k: cuda_gjk.gjk_diffset(torch.as_tensor(a), k)
        theirs = lambda k: pg.gjk_diffset(jnp.asarray(a), iters=k)
    u = _edge_u(tuple(c.astype(np.float32) for c in x) if isinstance(x, tuple) else a)
    _assert_one_round_equal(ours(1), theirs(1), u, 1e-5)
    _assert_same_brackets(ours, theirs, u, iters, 1e-5)
    if n_brute:
        got = ours(iters)
        true = kernel_cases.brute_origin_dist(u[:n_brute])
        scale = np.abs(u[:n_brute]).reshape(n_brute, -1).max(1)
        assert ((_np(got.lb)[:n_brute] - true) / scale).max() <= 1e-5
        assert ((true - _np(got.dist)[:n_brute]) / scale).max() <= 1e-5


@pytest.mark.parametrize(
    "m,n,want",
    [(1, 16, ("registers", 1, 1)), (2, 16, ("registers", 1, 2)), (3, 64512, ("registers", 1, 3)),
     (6, 256, ("registers", 4, 2)), (6, 64512, ("registers", 1, 6)),
     (12, 130, ("registers", 8, 2)), (12, 8192, ("registers", 1, 12)),
     (13, 8192, ("registers", 1, 18)), (24, 1024, ("registers", 8, 3)),
     (36, 16, ("registers", 8, 5)), (36, 1056, ("registers", 8, 5)),
     (36, 1057, ("registers", 4, 9)), (36, 2112, ("registers", 4, 9)),
     (36, 2113, ("registers", 1, 36)), (36, 64512, ("registers", 1, 36)),
     (37, 24, ("registers", 8, 5)), (37, 64512, ("registers", 4, 12)),
     (64, 16, ("registers", 8, 8)), (64, 8192, ("registers", 4, 16)),
     (65, 12, ("shared", 32, 0)), (144, 16384, ("shared", 32, 0)), (512, 1, ("shared", 32, 0)),
     (513, 3, ("device", 32, 0)), (100000, 1, ("device", 32, 0))],
)
def test_fw_route_by_m(m, n, want):
    """K5's route is a pure function of m and the batch n, defined for every
    m >= 1: no lane of a register-tier group is empty, its slots hold every
    vertex, and the most lanes a problem whose lanes stay within
    FW_IDLE_LANES are taken."""
    route = cuda_gjk.fw_route(m, n)
    assert tuple(route) == want
    if route.tier == "registers":
        assert route.g <= m <= route.g * route.vpl and route.vpl in cuda_gjk.FW_VPL[route.g]
        assert route.g in cuda_gjk.FW_ROUTE_G


def test_fw_builds_match_the_kernel_source():
    """`FW_VPL` lists the register tier's builds that csrc/gjk_fw.cu makes."""
    import pathlib
    import re

    src = (pathlib.Path(cuda_gjk.__file__).parent.parent / "csrc" / "gjk_fw.cu").read_text()
    builds = src[src.index("#define TRAJOPT_FW_BUILDS"):].split("\n\n", 1)[0]
    got = {(int(g), int(v)) for g, v in re.findall(r"X\((\d+), (\d+)\)", builds)}
    assert got == {(g, v) for g, vs in cuda_gjk.FW_VPL.items() for v in vs}


def test_fw_route_refuses_an_empty_set():
    with pytest.raises(ValueError, match="m >= 1"):
        cuda_gjk.fw_route(0, 1)


def test_fw_edge_sets_reach_the_tier_they_name():
    tiers = set()
    for name, x, _, _ in _FW_EDGES:
        u = _edge_u(x)
        tier = cuda_gjk.fw_route(u.shape[1], u.shape[0]).tier
        assert name.endswith(f"({tier})")
        tiers.add(tier)
    assert tiers == {"registers", "shared", "device"}


@pytest.mark.parametrize("m", [36, 65, 144, 513])
def test_gjk_diffset_takes_any_m_off_the_cpu(m):
    """Off the CPU every m goes to the kernel route, which takes contiguous
    float32 CUDA tensors only (float64 raises TypeError, another device
    ValueError): no size is refused and none falls back to the plain
    version."""
    with pytest.raises(TypeError, match="float32"):
        cuda_gjk.gjk_diffset(torch.empty(4, m, 3, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gjk.gjk_diffset(torch.empty(4, m, 3, dtype=torch.float32, device="meta"))


# ---------------------------------------------------------------------------
# The fleet's planes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet():
    """Three robots of the tests/test_multi.py fixture (res 4, 3 pieces, a
    sphere of obstacles) moved next to the sphere, and a direction that
    sweeps them into it and into each other."""
    cfg, ops, jc, jscene, jstate = make_problem(uav_num=3, with_obstacles=True)
    rng = np.random.default_rng(11)
    spline = np.asarray(jstate.spline) + np.array([0.0, 1.45, 0.0])
    spline[:, 2:-2] += rng.normal(scale=0.05, size=spline[:, 2:-2].shape)
    jstate = jstate._replace(spline=jnp.asarray(spline))
    direction = rng.normal(scale=0.4, size=spline.shape)
    direction[:, :2] = direction[:, -2:] = 0.0
    conv = functools.partial(tt.from_numpy, **F64)
    return cfg, jc, jscene, jstate, jnp.asarray(direction), conv(jc), conv(jscene), conv(jstate), \
        torch.as_tensor(direction, **F64)


def test_from_numpy_converts_a_fleet_state(fleet):
    _, _, _, jstate, _, _, _, state, _ = fleet
    assert isinstance(state, tt.SolverState)
    for got, want in zip(state, jstate):
        assert got.dtype == torch.float64 and got.shape == want.shape
        _close(got, want, 0.0)
    assert state.piece_time.shape == (3,)


@pytest.mark.parametrize("piece_budget", [32, 2])
def test_fleet_candidates_match_jax(fleet, piece_budget):
    cfg, jc, jscene, jstate, _, c, scene, state, _ = fleet
    jh = jax.vmap(lambda s: jen.seg_cps(jc, s))(jstate.spline)
    want, wov = jbp.fleet_candidates(jh, jscene, 0.6, 8, coarse_k=16, piece_budget=piece_budget)
    got, ov = bp.fleet_candidates(en.seg_cps(c, state.spline), scene, 0.6, 8, coarse_k=16,
                                  piece_budget=piece_budget)
    for g, w in zip(got, want):
        _close(g, w)
    _close(ov, wov)
    assert bool(got.mask.any())
    assert bool(ov) == (piece_budget == 2)


@pytest.mark.parametrize("budget", [1024, 5])
def test_separate_planes_batch_matches_jax(fleet, budget):
    cfg, jc, jscene, jstate, _, c, scene, state, _ = fleet
    cfg = cfg.replace(plane_gjk_budget=budget)
    want = jax.jit(jadmm.separate_planes_batch, static_argnums=1)(jc, cfg, jstate.spline, jscene)
    got = admm.separate_planes_batch(c, port_cfg(cfg), state.spline, scene)
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    _close(got[1], want[1])
    assert 0 < int(got[0].mask.sum()) <= budget


def test_separate_planes_batch_dead_branch_matches_jax():
    cfg, ops, jc, jscene, jstate = make_problem(uav_num=2)
    conv = functools.partial(tt.from_numpy, **F64)
    want = jax.jit(jadmm.separate_planes_batch, static_argnums=1)(jc, cfg, jstate.spline, jscene)
    got = admm.separate_planes_batch(conv(jc), port_cfg(cfg), conv(jstate).spline, conv(jscene))
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    assert not bool(got[0].mask.any())


@pytest.mark.parametrize("spread", [1.0, 10.0], ids=["live", "dead"])
def test_self_planes_match_jax(fleet, spread):
    """live: robots 0.26 apart (inside the 0.3 band); dead: spread apart so
    no pair is in radius."""
    cfg, jc, _, jstate, _, c, _, state, _ = fleet
    scale = np.array([1.0, 1.0, spread])
    js = jnp.asarray(np.asarray(jstate.spline) * scale)
    want = jax.jit(jmulti.self_planes, static_argnums=1)(jc, cfg, js)
    got = multi.self_planes(c, port_cfg(cfg), torch.as_tensor(np.array(js), **F64))
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    _close(got[1], want[1])
    assert bool(got[0].mask.any()) == (spread == 1.0)


def test_optimal_d_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(12, 6, 3)) * 0.3
    b = rng.normal(size=(12, 6, 3)) * 0.3 + np.array([0.0, 0.0, 0.9])
    hd = jax.vmap(lambda x, y: jgeo.hull_hull_distance(x, y, 48))(jnp.asarray(a), jnp.asarray(b))
    cn = np.asarray(hd.v) / np.asarray(hd.dist)[:, None]
    d = 0.5 * (np.min(-np.einsum("nmd,nd->nm", b, cn), 1) + np.max(-np.einsum("nmd,nd->nm", a, cn), 1))
    d[:3] += 0.4                                           # infeasible starts stay put
    want = jax.vmap(lambda x, y, cc, dd: jgeo._optimal_d(x, y, cc, dd, 0.1, 0.1, 8))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(cn), jnp.asarray(d))
    t = lambda x: torch.as_tensor(x, **F64)
    got = geo.optimal_d(t(a), t(b), t(cn), t(d), 0.1, 0.1, 8)
    _close(got, want)
    assert not np.allclose(np.asarray(want)[3:], d[3:])


# ---------------------------------------------------------------------------
# Robot-pair CCD
# ---------------------------------------------------------------------------


def _pair_inputs(fleet, dir_scale):
    cfg, jc, _, jstate, jdir, c, _, state, direction = fleet
    jh = jax.vmap(lambda s: jen.seg_cps(jc, s))(jstate.spline)
    jd = jax.vmap(lambda s: jen.seg_cps(jc, s))(jdir * dir_scale)
    h, d = en.seg_cps(c, state.spline), en.seg_cps(c, direction * dir_scale)
    return (jh, jd, jnp.arange(3, dtype=jnp.int32)), (h, d, torch.arange(3))


@pytest.mark.parametrize("dir_scale", [1e-3, 1.0], ids=["all_clear", "levels_23"])
def test_pair_max_step_direct_matches_jax(fleet, dir_scale):
    (jh, jd, jg), (h, d, g) = _pair_inputs(fleet, dir_scale)
    fn = jax.jit(jccd.pair_max_step_direct, static_argnums=(5, 6, 7, 8, 9))
    want = fn(jh, jd, jh, jd, jg, 0.1, 24, False, 4, 2)
    got = ccd.pair_max_step_direct(h, d, h, d, g, 0.1, 24, k_partners=4, n_slots=2)
    _close(got, want)
    if dir_scale == 1.0:
        assert float(got.min()) < 1.0


def test_pair_ccd_tables_and_pair_bad_match_jax(fleet):
    (jh, jd, jg), (h, d, g) = _pair_inputs(fleet, 1.0)
    jtabs = jccd.build_pair_ccd(jh, jd, jh, jd, jg, 2)
    tabs = ccd.build_pair_ccd(h, d, h, d, g, 2)
    for name in ("my_hp", "my_dp", "all_hp", "all_dp", "not_self"):
        _close(getattr(tabs, name), getattr(jtabs, name))
    assert tabs.n_slots == jtabs.n_slots
    fn = jax.jit(jccd.pair_bad, static_argnums=(3, 4, 5))
    seen = set()
    for steps in ([1.0, 1.0, 1.0], [4.0, 0.5, 0.05], [4.0, 4.0, 4.0], [0.0, 0.0, 0.0]):
        s = np.asarray(steps)
        want = fn(jtabs, jnp.asarray(s), jnp.asarray(s), 0.1, 24, False)
        got = ccd.pair_bad(tabs, torch.as_tensor(s, **F64), torch.as_tensor(s, **F64), 0.1, 24)
        _close(got, want)
        seen.add(bool(got.any()))
    assert seen == {True, False}


@pytest.mark.parametrize("dir_scale", [1e-3, 1.0])
def test_ccd_steps_match_jax(fleet, dir_scale):
    cfg, jc, jscene, jstate, jdir, c, scene, state, direction = fleet
    tcfg = port_cfg(cfg)
    jfn = jax.jit(jmulti.coupled_ccd_step, static_argnums=(1, 5))
    _close(multi.coupled_ccd_step(c, tcfg, state.spline, direction * dir_scale, scene),
           jfn(jc, cfg, jstate.spline, jdir * dir_scale, jscene, None))
    jfn = jax.jit(jmulti.decoupled_ccd_steps, static_argnums=(1, 5))
    got = multi.decoupled_ccd_steps(c, tcfg, state.spline, direction * dir_scale, scene)
    _close(got, jfn(jc, cfg, jstate.spline, jdir * dir_scale, jscene, None))
    if dir_scale == 1.0:
        assert float(got.min()) < 1.0


# ---------------------------------------------------------------------------
# The port's copies of the JAX-free host modules
# ---------------------------------------------------------------------------


def test_config_copy_equals_source():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.TrajOptConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.TrajOptConfig)}
    assert jf == tf
    assert (tconfig.ORDER, tconfig.DER) == (jconfig.ORDER, jconfig.DER)
    cfg = jconfig.TrajOptConfig(res=4, decouple=False)
    assert dataclasses.asdict(port_cfg(cfg)) == dataclasses.asdict(cfg)
    assert port_cfg(cfg).order == cfg.order and port_cfg(cfg).der == cfg.der


def test_spline_ops_copy_equals_source():
    for pieces, res in ((3, 4), (4, 8)):
        for got, want in zip(tsp.build_spline_ops(pieces, res), jsp.build_spline_ops(pieces, res)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(tsp.piece_row_index(pieces, 5), jsp.piece_row_index(pieces, 5))


def test_generators_and_io_copies_equal_sources(tmp_path):
    cases = [
        ("sphere_scene", dict(n_points=300, seed=3)),
        ("bridge_scene", dict(n_points=500, seed=1, n_pieces=4)),
        ("cross_scene", dict(n_points=400, seed=2)),
        ("cross_waypoints", dict(uav_num=16, n_pieces=4)),
    ]
    for name, kw in cases:
        got, want = getattr(tgen, name)(**kw), getattr(jgen, name)(**kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), name
    cloud = jgen.cross_scene(n_points=400, seed=2)
    wps = jgen.cross_waypoints(8, 4)
    assert tgen.assign_lanes(wps, cloud).tobytes() == jgen.assign_lanes(wps, cloud).tobytes()
    obj = tmp_path / "c.obj"
    obj.write_text("".join(f"v {x} {y} {z}\nf 1 2 3\n" for x, y, z in cloud[:20]))
    assert tio.read_obj_vertices(str(obj)).tobytes() == jio.read_obj_vertices(str(obj)).tobytes()
