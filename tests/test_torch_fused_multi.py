"""The torch port's fused multi-robot drivers (`solve_fused_multi`, coupled
and decoupled, and `solve_fused_multi_cached` with its plane caches) against
the JAX package's on the CPU in float64: two robots crossing at right angles
past a sphere of obstacles (tests/test_torch_fused.py's fleet), res 2, 2
pieces, to convergence."""

import numpy as np
import pytest
import torch

from trajopt_tpu import types as jt
from trajopt_tpu.config import TrajOptConfig
from trajopt_tpu.ops import splines as jsp
from trajopt_tpu.scenes import generators as jgen
from trajopt_tpu.solver import driver as jdriver
from trajopt_tpu.solver import multi as jmulti
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.solver import driver

from tests.test_torch_fused import _close, port_cfg

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
MAX_ITERS = 40


def jax_fleet(**options):
    cfg = TrajOptConfig(res=2, max_planes=4, max_self_planes=2, max_ccd_candidates=4, ks=1e-3,
                        **options)
    t = np.linspace(0, 1, 3)[:, None]
    wps = [np.array([-3.0, 0, 0]) * (1 - t) + np.array([3.0, 0, 0]) * t,
           np.array([0, -3.0, 0.15]) * (1 - t) + np.array([0, 3.0, 0.15]) * t]
    ops = jsp.build_spline_ops(2, cfg.res)
    cloud = jgen.sphere_scene(200, radius=0.3, center=(1.5, 0.42, 0.0))
    return (cfg, jt.device_consts(ops), jt.make_scene(cloud),
            jmulti.init_multi_state(ops, wps, cfg.init_piece_time))


def _port(*jax_side):
    return [tt.from_numpy(x, **F64) for x in jax_side]


def _check(state, it, gnorm, jfinal, jit_, jgnorm, cfg):
    assert int(it) == int(jit_) < MAX_ITERS and float(gnorm) < cfg.stop
    assert it.dtype == torch.int64 and it.shape == () and gnorm.shape == ()
    _close(state.spline, jfinal.spline, 1e-8)
    _close(state.piece_time, jfinal.piece_time, 1e-8)
    _close(gnorm, jgnorm, 1e-6)


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
def test_solve_fused_multi_matches_jax(coupled):
    """The same iteration count, splines and piece times to rtol 1e-8,
    gnorm to rtol 1e-6."""
    cfg, jc, jscene, jstate = jax_fleet()
    jfinal, jit_, jgnorm = jdriver.solve_fused_multi(jc, cfg, jstate, jscene, coupled,
                                                     max_iters=MAX_ITERS)
    consts, scene, state0 = _port(jc, jscene, jstate)
    state, it, gnorm = driver.solve_fused_multi(consts, port_cfg(cfg), state0, scene, coupled,
                                                max_iters=MAX_ITERS)
    _check(state, it, gnorm, jfinal, jit_, jgnorm, cfg)


def test_solve_fused_multi_cached_matches_jax():
    """With ``optimal_plane`` and the caches carried through the loop: the
    state as above, and the final caches: obstacle ids and pair partners
    equal, planes to rtol 1e-8."""
    cfg, jc, jscene, jstate = jax_fleet(optimal_plane=True)
    jcaches = jmulti.init_multi_caches(cfg, jc, 2, jstate.spline.dtype)
    jfinal, jit_, jgnorm, (jobs, jpair) = jdriver.solve_fused_multi_cached(
        jc, cfg, jstate, jscene, True, jcaches, max_iters=MAX_ITERS)
    consts, scene, state0 = _port(jc, jscene, jstate)
    caches = tuple(_port(*jcaches))
    state, it, gnorm, (obs, pair) = driver.solve_fused_multi_cached(
        consts, port_cfg(cfg), state0, scene, True, caches, max_iters=MAX_ITERS)
    _check(state, it, gnorm, jfinal, jit_, jgnorm, cfg)
    np.testing.assert_array_equal(obs.obs_id.numpy(), np.asarray(jobs.obs_id))
    np.testing.assert_array_equal(pair.partner.numpy(), np.asarray(jpair.partner))
    assert (pair.partner >= 0).any() and (obs.obs_id >= 0).any()
    _close(obs.c, jobs.c, 1e-8)
    _close(pair.c, jpair.c, 1e-8)
    _close(pair.d, jpair.d, 1e-8)
