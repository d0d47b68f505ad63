"""The torch port's checkpoints (`trajopt_tpu_torch.runtime.checkpoint`) on
the CPU, in float64: round trips, resume of single and fleet solves (with
and without the ``optimal_plane`` caches) against uninterrupted runs, the
manager's ``every`` / ``keep``, and npz files crossing between the port and
`trajopt_tpu.runtime.checkpoint` in both directions."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import types as jt
from trajopt_tpu.runtime import checkpoint as jckpt
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.config import TrajOptConfig
from trajopt_tpu_torch.ops import splines as sp
from trajopt_tpu_torch.runtime import checkpoint as ckpt
from trajopt_tpu_torch.scenes import generators as gen
from trajopt_tpu_torch.solver import driver, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


# the single-robot solves below stop and resume where the planes are live
# (from iteration 19 on the sphere fixture)
STOP, TOTAL = 22, 26


def single_problem(optimal_plane=False):
    """The sphere fixture of tests/test_torch_solver.py at res 2."""
    cfg = TrajOptConfig(res=2, max_planes=8, max_ccd_candidates=8, optimal_plane=optimal_plane)
    cloud = gen.sphere_scene(n_points=400, radius=1.0, seed=1)
    wp = np.array([[-3.0, 0.0, 0.0], [-1.5, 1.6, 0.0], [0.0, 1.8, 0.0],
                   [1.5, 1.6, 0.0], [3.0, 0.0, 0.0]])
    ops = sp.build_spline_ops(len(wp) - 1, cfg.res)
    return (cfg, tt.device_consts(ops, **F64), tt.make_scene(cloud, **F64),
            tt.init_state(ops, wp, cfg.init_piece_time, **F64))


def fleet_problem(optimal_plane=False):
    """tests/test_batch_and_checkpoint.py::_multi_cross_problem: two
    antiparallel robots 0.26 apart, obstacles far away."""
    cfg = TrajOptConfig(res=4, max_planes=8, max_self_planes=4, max_ccd_candidates=8,
                        ks=1e-3, optimal_plane=optimal_plane)
    wps = []
    for i in range(2):
        s = np.array([(1 if i % 2 == 0 else -1) * 3.0, 0.0, 0.26 * i])
        t = np.linspace(0, 1, 4)[:, None]
        wps.append(s * (1 - t) + s * np.array([-1.0, 1.0, 1.0]) * t)
    ops = sp.build_spline_ops(3, cfg.res)
    return (cfg, tt.device_consts(ops, **F64), tt.make_scene(np.full((8, 3), 100.0), **F64),
            multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64))


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_roundtrip(tmp_path):
    _, _, _, state = single_problem()
    p = tmp_path / "ck.npz"
    ckpt.save(str(p), state, step=7, extra={"gnorm": 0.5})
    restored, meta = ckpt.load(str(p), **F64)
    assert meta["step"] == 7 and meta["extra"] == {"gnorm": 0.5}
    assert meta["has_plane_cache"] is False and meta["cache_kind"] is None
    _equal(tt.to_numpy(state), tt.to_numpy(restored))
    assert ckpt.load_full(str(p), **F64)[2] is None


def _resume_matches(tmp_path, solve, optimal_plane, problem, stop, total):
    cfg, consts, scene, state = problem(optimal_plane)
    ref, hist = solve(consts, cfg, state, scene, max_iters=total)
    mgr = ckpt.CheckpointManager(str(tmp_path), every=1, keep=2)
    solve(consts, cfg, state, scene, max_iters=stop, checkpointer=mgr)
    resumed, hist2 = solve(consts, cfg, state, scene, max_iters=total, checkpointer=mgr)
    assert [h["iter"] for h in hist2] == [h["iter"] for h in hist[stop:]]
    assert [h["n_planes"] for h in hist2] == [h["n_planes"] for h in hist[stop:]]
    for f, a, b in zip(ref._fields, ref, resumed):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=0,
                                   err_msg=f"resume diverged in {f}")
    return hist


@pytest.mark.parametrize("optimal_plane", [False, True], ids=["default", "optimal_plane"])
def test_resume_matches_uninterrupted(tmp_path, optimal_plane):
    """tests/test_batch_and_checkpoint.py::test_resume_matches_uninterrupted
    on the port: 22 iterations, then a resume to 26, equal to 26 in one go
    at rtol 1e-12, with live planes on both sides of the cut; under
    ``optimal_plane`` the saved plane cache carries the refinement over."""
    def solve(*args, **kw):
        return driver.solve(*args, validate_init=False, **kw)

    hist = _resume_matches(tmp_path, solve, optimal_plane, single_problem, STOP, TOTAL)
    assert hist[STOP - 1]["n_planes"] > 0 and hist[-1]["n_planes"] > 0


@pytest.mark.parametrize("optimal_plane", [False, True], ids=["default", "optimal_plane"])
def test_multi_resume_matches_uninterrupted(tmp_path, optimal_plane):
    """tests/test_batch_and_checkpoint.py::test_multi_resume_matches_uninterrupted
    and ::test_multi_resume_optimal_plane_caches on the port (coupled), with
    live pair planes."""
    def solve(*args, **kw):
        return driver.solve_multi(*args, coupled=True, **kw)

    hist = _resume_matches(tmp_path, solve, optimal_plane, fleet_problem, 4, 8)
    assert sum(h["n_planes"] for h in hist) > 0


def test_multi_cache_checkpoint_roundtrip(tmp_path):
    """(obstacle PlaneCache, PairPlaneCache) round trip; ids go to the file
    as int32, as the JAX writer puts them, and come back int64."""
    cfg, consts, _, state = fleet_problem(True)
    obs, pair = multi.init_multi_caches(cfg, consts, 2, **F64)
    obs.obs_id[0, 0, 0, 0] = 5
    pair.partner[1, 0, 0, 0] = 0
    pair.d[1, 0, 0, 0] = 0.25
    p = tmp_path / "ck.npz"
    ckpt.save(str(p), state, step=3, cache=(obs, pair))
    with np.load(p) as z:
        assert z["plane_cache_obs_id"].dtype == np.int32
        assert z["pair_cache_partner"].dtype == np.int32
    restored_state, meta, (r_obs, r_pair) = ckpt.load_full(str(p), **F64)
    assert meta["cache_kind"] == "multi" and meta["has_plane_cache"] is True
    assert r_obs.obs_id.dtype == torch.int64 and r_pair.partner.dtype == torch.int64
    _equal(tt.to_numpy(obs), tt.to_numpy(r_obs))
    _equal(tt.to_numpy(pair), tt.to_numpy(r_pair))
    _equal(tt.to_numpy(state), tt.to_numpy(restored_state))


def test_checkpoint_manager_every_and_keep(tmp_path):
    _, _, _, state = single_problem()
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), every=3, keep=2)
    saved = [it for it in range(10) if mgr.maybe_save(it, state, extra={"gnorm": float(it)})]
    assert saved == [0, 3, 6, 9]
    names = sorted(p.name for p in (tmp_path / "run").iterdir())
    assert names == ["ckpt_00000006.npz", "ckpt_00000009.npz"]
    assert mgr.latest().endswith("ckpt_00000009.npz")
    state2, meta = mgr.restore_latest(**F64)
    assert meta["step"] == 9 and meta["extra"]["gnorm"] == 9.0
    assert ckpt.CheckpointManager(str(tmp_path / "empty")).restore_latest_full(**F64) is None


def _jax_cache(cache):
    """The port's PlaneCache as the JAX package's, int32 ids."""
    return jt.PlaneCache(obs_id=jnp.asarray(cache.obs_id.numpy(), dtype=jnp.int32),
                         c=jnp.asarray(cache.c.numpy()))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """An npz that `trajopt_tpu.runtime.checkpoint.save` writes (state and
    live plane cache of the port's iteration 21) resumes in the port's
    `driver.solve` to the port's uninterrupted result."""
    cfg, consts, scene, state = single_problem(True)
    ref, _ = driver.solve(consts, cfg, state, scene, max_iters=TOTAL, validate_init=False)
    mgr = ckpt.CheckpointManager(str(tmp_path / "port"), every=1, keep=1)
    driver.solve(consts, cfg, state, scene, max_iters=STOP, checkpointer=mgr,
                 validate_init=False)
    mid, meta, cache = mgr.restore_latest_full(**F64)
    assert meta["cache_kind"] == "single" and int((cache.obs_id >= 0).sum()) > 0
    jstate = jt.SolverState(*(jnp.asarray(x) for x in tt.to_numpy(mid)))
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), every=1, keep=1)
    jmgr.maybe_save(meta["step"], jstate, extra=meta["extra"], cache=_jax_cache(cache))
    resumed, hist = driver.solve(consts, cfg, state, scene, max_iters=TOTAL,
                                 validate_init=False,
                                 checkpointer=ckpt.CheckpointManager(str(tmp_path / "jax")))
    assert hist[0]["iter"] == STOP
    for f, a, b in zip(ref._fields, ref, resumed):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=0, err_msg=f)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_port_checkpoint_loads_in_jax(tmp_path, kind):
    """An npz the port writes loads in `trajopt_tpu.runtime.checkpoint.load_full`
    with the same arrays, float dtypes, int32 ids and meta."""
    if kind == "single":
        cfg, consts, scene, state = single_problem(True)
        state, _ = driver.solve(consts, cfg, state, scene, max_iters=3, validate_init=False)
        cache = tt.empty_plane_cache(consts.piece_num, consts.res, cfg.max_planes, **F64)
        cache.obs_id[1, 0, 2] = 17
        cache.c[1, 0, 2] = torch.tensor([0.0, 0.6, 0.8], **F64)
    else:
        cfg, consts, scene, state = fleet_problem(True)
        state, _ = driver.solve_multi(consts, cfg, state, scene, coupled=True, max_iters=3)
        obs, pair = multi.init_multi_caches(cfg, consts, 2, **F64)
        pair.partner[0, 1, 1, 0] = 1
        pair.d[0, 1, 1, 0] = -0.13
        cache = (obs, pair)
    p = tmp_path / "ck.npz"
    ckpt.save(str(p), state, step=2, extra={"gnorm": 0.25}, cache=cache)
    jstate, meta, jcache = jckpt.load_full(str(p))
    assert meta == json.loads(json.dumps({"step": 2, "fields": list(state._fields),
                                          "extra": {"gnorm": 0.25}, "has_plane_cache": True,
                                          "cache_kind": kind}))
    _equal(tt.to_numpy(state), jstate)
    for x in jstate:
        assert np.asarray(x).dtype == np.float64
    pairs = [(cache, jcache)] if kind == "single" else list(zip(cache, jcache))
    for got, want in pairs:
        _equal(tt.to_numpy(got), want)
        assert np.asarray(want[0]).dtype == np.int32
