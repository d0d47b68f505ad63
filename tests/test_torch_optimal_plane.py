"""The torch port's single-robot ``optimal_plane=True`` path against the JAX
package on the CPU, in float64: the barrier-optimal plane refinements, the
cached separating planes, the cached step, the solve and both CLIs; and the
plane-cache properties of tests/test_optimal_plane.py run on the port.  The
fleet's cached path is in test_torch_optimal_plane_multi.py."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import metrics as jmt
from trajopt_tpu import types as jt
from trajopt_tpu.config import TrajOptConfig
from trajopt_tpu.ops import geometry as jgeo
from trajopt_tpu.ops import splines as sp
from trajopt_tpu.scenes import generators as gen
from trajopt_tpu.solver import admm as jadmm
from trajopt_tpu.solver import driver as jdriver
from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import testing
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import energies as en
from trajopt_tpu_torch.ops import geometry as geo
from trajopt_tpu_torch.solver import admm, driver

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
OFFSET, MARGIN = 0.1, 0.3
PAIR_MARGIN = 0.1


def port_cfg(cfg):
    """The port's TrajOptConfig with the JAX one's fields."""
    return tconfig.TrajOptConfig(**dataclasses.asdict(cfg))


def _close(got, want, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1e-300))


def _close_all(got, want, rtol=1e-8):
    for g, w in zip(tt.to_numpy(got), want):
        _close(g, w, rtol)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# The refinements, on seeded batches
# ---------------------------------------------------------------------------


def plane_cases(kind, n=32, seed=0):
    """Hulls [n,6,3] above obstacle points, and start normals: "near" from the
    plane-fit direction tilted, so that the barrier band is live; "far" out
    of the barrier band (the refinement must leave them); "infeasible" tilted
    so far that some hull points fall behind the plane."""
    rng = np.random.default_rng({"near": 0, "far": 1, "infeasible": 2}[kind] + 10 * seed)
    lift = {"near": 0.3, "far": 3.0, "infeasible": 0.3}[kind]
    hull = rng.standard_normal((n, 6, 3)) * 0.1 + np.array([0.0, 0.0, lift])
    point = rng.standard_normal((n, 3)) * 0.03
    tilt = {"near": 0.3, "far": 0.3, "infeasible": 2.0}[kind]
    c = _unit(np.array([0.0, 0.0, 1.0]) + tilt * rng.standard_normal((n, 3)))
    return hull, point, c


def pair_cases(kind, n=32, seed=0):
    """Hull pairs [n,6,3] x2 on either side of z = 0 and start normals and
    midplane offsets ("near": inside the band, "far": beyond it,
    "infeasible": normals tilted across the hulls)."""
    rng = np.random.default_rng({"near": 3, "far": 4, "infeasible": 5}[kind] + 10 * seed)
    gap = {"near": 0.18, "far": 2.0, "infeasible": 0.18}[kind]
    a = rng.standard_normal((n, 6, 3)) * 0.08 + np.array([0.0, 0.0, gap])
    b = rng.standard_normal((n, 6, 3)) * 0.08 - np.array([0.0, 0.0, gap])
    tilt = {"near": 0.25, "far": 0.25, "infeasible": 2.0}[kind]
    c = _unit(np.array([0.0, 0.0, 1.0]) + tilt * rng.standard_normal((n, 3)))
    d = 0.5 * ((-(b @ c[:, :, None])[..., 0]).min(1) + (-(a @ c[:, :, None])[..., 0]).max(1))
    return a, b, c, d


@functools.lru_cache(maxsize=None)
def _jax_refiners():
    single = jax.jit(jax.vmap(lambda h, p, c: jgeo.refine_plane(h, p, c, OFFSET, MARGIN)))
    pair = jax.jit(jax.vmap(
        lambda a, b, c, d: jgeo.refine_pair_plane(a, b, c, d, OFFSET, PAIR_MARGIN)))
    return single, pair


@pytest.mark.parametrize("kind", ["near", "far", "infeasible"])
def test_refine_plane_matches_jax(kind):
    hull, point, c = plane_cases(kind)
    jc, jd = _jax_refiners()[0](hull, point, c)
    tc, td = geo.refine_plane(*(torch.tensor(x) for x in (hull, point, c)), OFFSET, MARGIN)
    _close(tc, jc, 1e-8)
    _close(td, jd, 1e-8)
    moved = np.abs(np.asarray(jc) - c).max(-1) > 1e-9
    behind = (np.einsum("bnd,bd->bn", hull - point[:, None], c) - OFFSET).min(-1) <= 0
    if kind == "far":
        assert not moved.any()          # w = 0 out of the band: never "better"
    elif kind == "near":
        assert moved.sum() >= 4
    else:
        assert behind.sum() >= 16       # the penalty branch of the energy


@pytest.mark.parametrize("kind", ["near", "far", "infeasible"])
def test_refine_pair_plane_matches_jax(kind):
    a, b, c, d = pair_cases(kind)
    jc, jd = _jax_refiners()[1](a, b, c, d)
    tc, td = geo.refine_pair_plane(*(torch.tensor(x) for x in (a, b, c, d)), OFFSET,
                                   PAIR_MARGIN)
    _close(tc, jc, 1e-8)
    _close(td, jd, 1e-8)
    moved = np.abs(np.asarray(jc) - c).max(-1) > 1e-9
    side_a = np.einsum("bnd,bd->bn", a, c) + d[:, None] - 0.5 * OFFSET
    side_b = -np.einsum("bnd,bd->bn", b, c) - d[:, None] - 0.5 * OFFSET
    behind = np.minimum(side_a.min(-1), side_b.min(-1)) <= 0
    if kind == "far":
        assert not moved.any()
    elif kind == "near":
        assert moved.sum() >= 4
    else:
        assert behind.sum() >= 16


def _energy(hull, point, c, d):
    dist = hull @ c + d
    if (dist <= 0).any():
        return np.inf
    x = dist[dist < MARGIN]
    return float(np.sum(-((x - MARGIN) ** 2) * np.log(x / MARGIN)))


def test_refined_plane_not_worse():
    """tests/test_optimal_plane.py::test_refined_plane_not_worse on the port:
    from the GJK plane, the refined plane's barrier energy is no higher, and
    the normal stays unit."""
    rng = np.random.default_rng(4)
    hull = rng.standard_normal((12, 6, 3)) * 0.2 + np.array([0, 0, 0.4])
    point = rng.standard_normal((12, 3)) * 0.05
    hd = geo.point_hull_distance(torch.tensor(hull), torch.tensor(point), 40)
    c = (hd.v / hd.dist[:, None]).numpy()
    d = -(c * point).sum(-1) - OFFSET
    c2, d2 = geo.refine_plane(*(torch.tensor(x) for x in (hull, point, c)), OFFSET, MARGIN)
    checked = 0
    for i in range(12):
        if float(hd.dist[i]) > OFFSET + MARGIN:
            continue
        e0 = _energy(hull[i], point[i], c[i], d[i])
        assert _energy(hull[i], point[i], c2[i].numpy(), float(d2[i])) <= e0 + 1e-8
        checked += 1
    np.testing.assert_allclose(np.linalg.norm(c2.numpy(), axis=-1), 1.0, atol=1e-6)
    assert checked >= 4


# ---------------------------------------------------------------------------
# The single-robot cached path, on the sphere fixture of test_torch_solver.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single():
    cfg = TrajOptConfig(res=4, max_planes=16, max_ccd_candidates=16, optimal_plane=True)
    cloud = gen.sphere_scene(n_points=400, radius=1.0, seed=1)
    wp = np.array([[-3.0, 0.0, 0.0], [-1.5, 1.6, 0.0], [0.0, 1.8, 0.0],
                   [1.5, 1.6, 0.0], [3.0, 0.0, 0.0]])
    ops = sp.build_spline_ops(len(wp) - 1, cfg.res)
    jstate0 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                           jt.init_state(ops, wp, cfg.init_piece_time))
    jc, jscene = jt.device_consts(ops), jt.make_scene(cloud)
    jfinal, jhist = jdriver.solve(jc, cfg, jstate0, jscene, max_iters=60, validate_init=False)
    return cfg, ops, wp, cloud, (jc, jscene, jstate0), jfinal, jhist


def _planes_live_state(single):
    """The JAX state and cache just before the first iterate with live planes."""
    cfg, _, _, _, (jc, jscene, jstate), _, jhist = single
    k = next(h["iter"] for h in jhist if h["n_planes"] > 0)
    cache = jt.empty_plane_cache(jc.piece_num, jc.res, cfg.max_planes, jnp.float64)
    for _ in range(k):
        jstate, _, cache = jadmm.admm_step_cached(jc, cfg, jstate, jscene, cache)
    return jstate, cache


@pytest.mark.parametrize("start", ["init", "planes_live"])
def test_cached_separate_planes_match_jax(single, start):
    """Three rounds of the cached plane table at a fixed spline: planes and
    the new cache equal JAX's, and the refinement moves live planes."""
    cfg, _, _, _, (jc, jscene, jstate), _, _ = single
    cache = jt.empty_plane_cache(jc.piece_num, jc.res, cfg.max_planes, jnp.float64)
    if start == "planes_live":
        jstate, cache = _planes_live_state(single)
    consts, scene = tt.from_numpy(jc, **F64), tt.from_numpy(jscene, **F64)
    tcache, spline = tt.from_numpy(cache, **F64), tt.from_numpy(jstate, **F64).spline
    jfn = jax.jit(jadmm.separate_planes, static_argnums=(1,))
    live = 0
    for _ in range(3):
        jplanes, jovf, cache = jfn(jc, cfg, jstate.spline, jscene, cache)
        planes, ovf, tcache = admm.separate_planes(consts, port_cfg(cfg), spline, scene, tcache)
        _close_all(planes, jplanes)
        _close_all(tcache, cache)
        assert not bool(ovf) and not bool(jovf)
        live += int(planes.mask.sum())
    assert live > 0 or start == "init"


@pytest.mark.parametrize("start", ["init", "planes_live"])
def test_three_admm_step_cached_match_jax(single, start):
    """State, StepDiag and cache after each of three cached steps, rtol 1e-8."""
    cfg, _, _, _, (jc, jscene, jstate), _, _ = single
    cache = jt.empty_plane_cache(jc.piece_num, jc.res, cfg.max_planes, jnp.float64)
    if start == "planes_live":
        jstate, cache = _planes_live_state(single)
    consts, scene = tt.from_numpy(jc, **F64), tt.from_numpy(jscene, **F64)
    state, tcache = tt.from_numpy(jstate, **F64), tt.from_numpy(cache, **F64)
    live = 0
    for _ in range(3):
        jstate, jdiag, cache = jadmm.admm_step_cached(jc, cfg, jstate, jscene, cache)
        state, diag, tcache = admm.admm_step_cached(consts, port_cfg(cfg), state, scene, tcache)
        _close_all(state, jstate)
        _close_all(diag, jdiag)
        _close_all(tcache, cache)
        live += int(diag.n_planes)
    assert live > 0 or start == "init"


def test_admm_step_optimal_plane_without_cache_matches_jax(single):
    """`admm_step` with ``optimal_plane`` refines from the GJK witness (no
    warm start): three steps from the planes-live state, rtol 1e-8."""
    cfg, _, _, _, (jc, jscene, _), _, _ = single
    jstate, _ = _planes_live_state(single)
    consts, scene = tt.from_numpy(jc, **F64), tt.from_numpy(jscene, **F64)
    state = tt.from_numpy(jstate, **F64)
    for _ in range(3):
        jstate, jdiag = jadmm.admm_step(jc, cfg, jstate, jscene)
        state, diag = admm.admm_step(consts, port_cfg(cfg), state, scene)
        _close_all(state, jstate)
        _close_all(diag, jdiag)
    assert int(diag.n_planes) > 0


def test_solve_optimal_plane_matches_jax(single):
    """The same iteration count and live-plane history as JAX, the final
    spline within 1e-6."""
    cfg, ops, wp, cloud, _, jfinal, jhist = single
    state, hist = driver.solve(
        tt.device_consts(ops, **F64), port_cfg(cfg),
        tt.init_state(ops, wp, cfg.init_piece_time, **F64), tt.make_scene(cloud, **F64),
        max_iters=60, validate_init=False,
    )
    assert len(hist) == len(jhist)
    assert hist[-1]["gnorm"] < cfg.stop
    assert [h["n_planes"] for h in hist] == [h["n_planes"] for h in jhist]
    assert sum(h["n_planes"] for h in hist) > 0
    np.testing.assert_allclose(state.spline.numpy(), np.asarray(jfinal.spline), atol=1e-6)
    np.testing.assert_allclose(float(state.piece_time), float(jfinal.piece_time), atol=1e-6)


def test_plane_cache_warm_start_not_worse():
    """tests/test_optimal_plane.py::test_plane_cache_warm_start_not_worse on
    the port: at a fixed state, three cached rounds reach a barrier energy
    no higher than one fresh refinement, on the same live slots."""
    cfg = tconfig.TrajOptConfig(res=2, max_planes=8, max_ccd_candidates=8, optimal_plane=True)
    cloud = gen.sphere_scene(300, radius=1.1, seed=3)
    wp = np.array([[-3.0, 0, 0], [-1.2, 1.25, 0], [1.2, 1.25, 0], [3.0, 0, 0]])
    ops = sp.build_spline_ops(len(wp) - 1, cfg.res)
    consts, scene = tt.device_consts(ops, **F64), tt.make_scene(cloud, **F64)
    state = tt.init_state(ops, wp, cfg.init_piece_time, **F64)

    def barrier(planes):
        return float(en.plane_barrier_energy(consts, cfg, state.spline, planes).value)

    fresh, _ = admm.separate_planes(consts, cfg, state.spline, scene)
    cache = tt.empty_plane_cache(consts.piece_num, consts.res, cfg.max_planes, **F64)
    for _ in range(3):
        cached, _, cache = admm.separate_planes(consts, cfg, state.spline, scene, cache)
    assert int(fresh.mask.sum()) > 0
    assert torch.equal(cached.mask, fresh.mask)
    assert torch.equal(cache.obs_id >= 0, cached.mask)
    assert barrier(cached) <= barrier(fresh) + 1e-9


@pytest.mark.parametrize("cli", ["single", "multi"])
def test_cli_runs_with_optimal_plane_config(tmp_path, capsys, cli):
    """A --config file with ``"optimal_plane": 1`` (the reference's switch,
    Config File/3D.json) runs on both CLIs."""
    from trajopt_tpu_torch.cli import multi as cli_multi
    from trajopt_tpu_torch.cli import single as cli_single

    config = tmp_path / "3D.json"
    config.write_text(json.dumps({"optimal_plane": 1, "res": 4}))
    argv = ["--config", str(config), "--cpu", "--x64", "--max-iters", "2",
            "--result-dir", str(tmp_path), "--metrics", str(tmp_path / "m.jsonl")]
    if cli == "single":
        rc = cli_single.main(["--scene", "sphere", "--n-points", "300"] + argv)
    else:
        rc = cli_multi.main(["--scene", "cross", "--uav-num", "2", "--n-points", "300"] + argv)
    assert rc == 0
    assert "iter: 2" in capsys.readouterr().out
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 2


def jax_rows(**options):
    """The JAX package's CPU float64 solves behind chip_smoke.py's gates
    held to JAX rows: the bridge (20000 points, P = 4) and the 64-robot
    cross coupled, in the configurations of chip_smoke.py's `build_problem`
    and `build_fleet` with ``options`` (``optimal_plane=True`` for
    `testing.OPTIMAL_PLANE_JAX_ROWS`, ``psd_method="ladder"`` for
    `testing.PSD_JAX_ROWS`).  Returns {"single p4": row, "u64 coupled":
    row}."""
    from trajopt_tpu.solver import multi as jmulti

    rows = {}
    cfg = TrajOptConfig(ks=1e-8, max_planes=16, max_ccd_candidates=16, **options)
    cloud, wp = gen.bridge_scene(n_points=20000, seed=0, n_pieces=4)
    ops = sp.build_spline_ops(4, cfg.res)
    state, hist = jdriver.solve(jt.device_consts(ops), cfg,
                                jt.init_state(ops, wp, cfg.init_piece_time),
                                jt.make_scene(cloud), max_iters=2000)
    spline, piece_time = np.asarray(state.spline), float(state.piece_time)
    st = jmt.trajectory_stats(ops, spline, piece_time)
    rows["single p4"] = dict(
        iters=len(hist), converged=len(hist) < 2000 and hist[-1]["gnorm"] < cfg.stop,
        ccd_time=st["ccd_time"], ccd_len=st["ccd_len"],
        min_clearance=float(jmt.min_curve_clearance(ops, spline, cloud, piece_time)))
    cfg = TrajOptConfig(res=8, ks=1e-3, max_planes=16, max_self_planes=4,
                        max_ccd_candidates=16, **options)
    cloud = gen.cross_scene(n_points=4000, seed=0)
    wps = gen.assign_lanes(gen.cross_waypoints(64, 4), cloud)
    ops = sp.build_spline_ops(4, cfg.res)
    state, hist = jdriver.solve_multi(jt.device_consts(ops), cfg,
                                      jmulti.init_multi_state(ops, wps, cfg.init_piece_time),
                                      jt.make_scene(cloud), coupled=True, max_iters=600)
    splines, times = np.asarray(state.spline), np.asarray(state.piece_time)
    stats = [jmt.trajectory_stats(ops, splines[i], float(times[i])) for i in range(64)]
    rows["u64 coupled"] = dict(
        iters=len(hist), converged=len(hist) < 600 and hist[-1]["gnorm"] < cfg.stop,
        ccd_time=sum(x["ccd_time"] for x in stats), ccd_len=sum(x["ccd_len"] for x in stats),
        min_clearance=min(float(jmt.min_curve_clearance(ops, splines[i], cloud, float(times[i])))
                          for i in range(64)))
    return rows


@pytest.mark.slow
def test_jax_rows_of_the_card_gates():
    """`testing.OPTIMAL_PLANE_JAX_ROWS`, which chip_smoke.py holds the card's
    ``optimal_plane`` solves to, are what the JAX package computes (~3 min)."""
    rows = jax_rows(optimal_plane=True)
    assert set(rows) == set(testing.OPTIMAL_PLANE_JAX_ROWS)
    for name, row in rows.items():
        want = testing.OPTIMAL_PLANE_JAX_ROWS[name]
        assert row["iters"] == want["iters"] and row["converged"] == want["converged"], name
        for key in ("ccd_time", "ccd_len", "min_clearance"):
            assert row[key] == pytest.approx(want[key], rel=1e-6), (name, key)
