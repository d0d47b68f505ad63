"""The torch port's multi-robot ``optimal_plane=True`` path against the JAX
package on the CPU, in float64: three cached fleet steps in each mode, the
cache shapes, the pair-cache property of tests/test_optimal_plane.py on the
port, and the fleet solve."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import types as jt
from trajopt_tpu.config import TrajOptConfig
from trajopt_tpu.ops import splines as sp
from trajopt_tpu.scenes import generators as gen
from trajopt_tpu.solver import driver as jdriver
from trajopt_tpu.solver import multi as jmulti
from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import energies as en
from trajopt_tpu_torch.solver import driver, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def port_cfg(cfg):
    """The port's TrajOptConfig with the JAX one's fields."""
    return tconfig.TrajOptConfig(**dataclasses.asdict(cfg))


def _close_all(got, want, rtol=1e-8):
    for g, w in zip(tt.to_numpy(got), want):
        w = np.asarray(w)
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            scale = float(np.max(np.abs(w))) if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(scale, 1e-300))


def antiparallel(uav_num=2, obstacles=False):
    """tests/test_optimal_plane.py's fleet: antiparallel passes 0.26 apart,
    inside the pair-plane band (res 2, 3 pieces); with ``obstacles`` the
    sphere of tests/test_multi.py beside them."""
    cfg = TrajOptConfig(res=2, max_planes=4, max_self_planes=2, max_ccd_candidates=4,
                        ks=1e-3, optimal_plane=True)
    wps = []
    for i in range(uav_num):
        sgn = 1 if i % 2 == 0 else -1
        s = np.array([sgn * 3.0, 0.12 * (i // 2), 0.26 * i])
        t = np.linspace(0, 1, 4)[:, None]
        wps.append(s * (1 - t) + s * np.array([-1.0, 1.0, 1.0]) * t)
    ops = sp.build_spline_ops(3, cfg.res)
    cloud = (gen.sphere_scene(200, radius=0.5, center=(0, -0.65, 0)) if obstacles
             else np.full((8, 3), 100.0))
    return cfg, ops, wps, cloud


@pytest.fixture(scope="module", params=["pair", "pair_and_obstacles"])
def fleet(request):
    obstacles = request.param == "pair_and_obstacles"
    cfg, ops, wps, cloud = antiparallel(3 if obstacles else 2, obstacles)
    jc, jscene = jt.device_consts(ops), jt.make_scene(cloud)
    jstate = jmulti.init_multi_state(ops, wps, cfg.init_piece_time)
    jstate = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), jstate)
    return cfg, ops, wps, cloud, jc, jscene, jstate, obstacles


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
def test_three_multi_cached_steps_match_jax(fleet, coupled):
    """State, StepDiag and both caches after each of three cached steps,
    rtol 1e-8, with live pair planes (and live obstacle planes where the
    fixture has obstacles)."""
    cfg, ops, wps, cloud, jc, jscene, jstate, obstacles = fleet
    caches = jmulti.init_multi_caches(cfg, jc, len(wps), jnp.float64)
    consts, scene = tt.from_numpy(jc, **F64), tt.from_numpy(jscene, **F64)
    state = tt.from_numpy(jstate, **F64)
    tcaches = tuple(tt.from_numpy(c, **F64) for c in caches)
    tcfg = port_cfg(cfg)
    pair_live = obs_live = 0
    for _ in range(3):
        jstate, jdiag, caches = jmulti.multi_admm_step_cached_jit(jc, cfg, jstate, jscene,
                                                                  coupled, caches)
        state, diag, tcaches = multi.multi_admm_step_cached(consts, tcfg, state, scene,
                                                            coupled, tcaches)
        _close_all(state, jstate)
        _close_all(diag, jdiag)
        for got, want in zip(tcaches, caches):
            _close_all(got, want)
        pair_live += int((tcaches[1].partner >= 0).sum())
        obs_live += int((tcaches[0].obs_id >= 0).sum())
    assert pair_live > 0
    assert obs_live > 0 or not obstacles


def test_init_multi_caches_shapes():
    cfg = tconfig.TrajOptConfig(res=2, max_planes=4, max_self_planes=3)
    ops = sp.build_spline_ops(3, cfg.res)
    consts = tt.device_consts(ops, **F64)
    for u, ks in ((1, 1), (2, 1), (5, 3)):
        obs, pair = multi.init_multi_caches(cfg, consts, u, **F64)
        assert obs.obs_id.shape == (u, 3, 2, 4) and obs.c.shape == (u, 3, 2, 4, 3)
        assert pair.partner.shape == (u, 3, 2, ks) and pair.c.shape == (u, 3, 2, ks, 3)
        assert pair.d.shape == (u, 3, 2, ks)
        assert bool((obs.obs_id == -1).all()) and bool((pair.partner == -1).all())
        assert obs.c.dtype == torch.float64 and obs.obs_id.dtype == torch.int64


def _pair_barrier(consts, cfg, splines, planes):
    return sum(float(en.plane_barrier_energy(
        consts, cfg, splines[i], tt.Planes(planes.c[i], planes.d[i], planes.mask[i])).value)
        for i in range(splines.shape[0]))


def test_multi_pair_plane_cache_not_worse():
    """tests/test_optimal_plane.py::test_multi_pair_plane_cache_not_worse on
    the port: three cached pair-plane rounds reach a pair barrier no higher
    than one fresh refinement, with a key for every live slot."""
    cfg, ops, wps, _ = antiparallel()
    cfg = port_cfg(cfg)
    consts = tt.device_consts(ops, **F64)
    splines = multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64).spline
    fresh, _ = multi.self_planes(consts, cfg, splines)
    _, cache = multi.init_multi_caches(cfg, consts, 2, **F64)
    for _ in range(3):
        cached, _, cache = multi.self_planes(consts, cfg, splines, cache)
    assert int(fresh.mask.sum()) > 0
    assert torch.equal(cached.mask, fresh.mask)
    assert torch.equal(cache.partner >= 0, cached.mask)
    assert _pair_barrier(consts, cfg, splines, cached) <= _pair_barrier(
        consts, cfg, splines, fresh) + 1e-6


def test_solve_multi_optimal_plane_matches_jax():
    """tests/test_optimal_plane.py::test_multi_solver_runs_with_optimal_plane
    against JAX: the same iterations and live-plane history, converged."""
    cfg, ops, wps, cloud = antiparallel()
    # strongly typed, as the fleet fixture's: the step compiled there is reused
    jstate = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                          jmulti.init_multi_state(ops, wps, cfg.init_piece_time))
    jfinal, jhist = jdriver.solve_multi(jt.device_consts(ops), cfg, jstate,
                                        jt.make_scene(cloud), coupled=True, max_iters=60)
    state, hist = driver.solve_multi(
        tt.device_consts(ops, **F64), port_cfg(cfg),
        multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64),
        tt.make_scene(cloud, **F64), coupled=True, max_iters=60)
    assert len(hist) == len(jhist) and hist[-1]["gnorm"] < cfg.stop
    assert [h["n_planes"] for h in hist] == [h["n_planes"] for h in jhist]
    np.testing.assert_allclose(state.spline.numpy(), np.asarray(jfinal.spline), atol=1e-6)


