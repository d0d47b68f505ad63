"""Robot and scenario sharding of the torch port (`parallel/sharded.py`) on
`torch.distributed`: two CPU processes on gloo in float64, held against the
port's one-process functions to rtol 1e-12 (the cross-rank sums add in
another order) and the sharded step also against the JAX package's at rtol
1e-8; a decoupled shrink whose ranks disagree on their own predicates
finishes; the CLI's ``--mesh-devices 2``; and, in this process,
`init_distributed` without an environment and the single-rank `make_mesh(1)`.

The two processes start by spawn and meet through a ``file://`` store in
the test's own directory (no port, so xdist workers cannot collide); each
case runs in the same two-process job, which has ``JOB_TIMEOUT`` seconds:
a hang fails the tests, and the processes are terminated."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests.test_sharded import make_problem as jax_fleet
from trajopt_tpu.solver import multi as jmulti
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.config import TrajOptConfig
from trajopt_tpu_torch.ops import splines as sp
from trajopt_tpu_torch.parallel import sharded
from trajopt_tpu_torch.runtime import graph
from trajopt_tpu_torch.scenes import generators as gen
from trajopt_tpu_torch.solver import driver, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
JOB_TIMEOUT = 120.0
WORLD = 2
CLI_ARGS = ["--scene", "cross", "--uav-num", "4", "--cpu", "--x64", "--n-points", "300",
            "--max-iters", "4"]


def fleet(uavs=4):
    """tests/test_sharded.py's fleet built by the port: ``uavs`` robots
    crossing in alternating directions, res 2, 2 pieces, a sphere of 64
    points."""
    cfg = TrajOptConfig(res=2, ks=1e-3, max_planes=4, max_self_planes=2, max_ccd_candidates=4)
    t = np.linspace(0, 1, 3)[:, None]
    wps = []
    for i in range(uavs):
        sgn = 1 if i % 2 == 0 else -1
        s = np.array([sgn * 3.0, 0.11 * (i // 2), 0.27 * i])
        wps.append(s * (1 - t) + (s * [-1, 1, 1]) * t)
    ops = sp.build_spline_ops(2, cfg.res)
    cloud = gen.sphere_scene(64, radius=0.5, center=(0, 2.0, 0.5))
    return (cfg, tt.device_consts(ops, **F64), tt.make_scene(cloud, **F64),
            multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64))


def conflict():
    """Four parallel robots in two pairs, and directions that keep the
    first pair apart (its pairs certified at step 1) and drive the second
    pair into each other (shrink rounds): with two ranks, rank 0's own
    predicate is false from the start and rank 1's true."""
    cfg, consts, scene, _ = fleet()
    t = np.linspace(0, 1, 3)[:, None]
    line = np.array([-3.0, 0, 0]) * (1 - t) + np.array([3.0, 0, 0]) * t
    wps = [line + [0, 0, 0], line + [0, 0, 2.0], line + [0, 4.0, 0], line + [0, 4.0, 0.15]]
    ops = sp.build_spline_ops(2, cfg.res)
    splines = multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64).spline
    directions = torch.zeros_like(splines)
    directions[0, :, 2], directions[1, :, 2] = -0.5, 0.5
    directions[2, :, 2], directions[3, :, 2] = 0.5, -0.5
    far = tt.make_scene(np.full((8, 3), 100.0), **F64)
    return cfg, consts, far, splines, directions


def scenarios(n=4):
    """``n`` single-UAV scenarios, each in its own sphere of 128 points
    (tests/test_batch_and_checkpoint.py's make_batch), P=3, res 2."""
    cfg = TrajOptConfig(res=2, max_planes=8, max_ccd_candidates=8)
    ops = sp.build_spline_ops(3, cfg.res)
    states, scenes = [], []
    for s in range(n):
        cloud = gen.sphere_scene(128, radius=0.8, seed=s, center=(0, 3.0 + 0.1 * s, 0))
        y = 1.7 + 0.1 * s
        wp = np.array([[-3.0, 0, 0], [-1.0, y, 0], [1.0, y, 0], [3.0, 0, 0]])
        scenes.append(tt.make_scene(cloud, **F64))
        states.append(tt.init_state(ops, wp, cfg.init_piece_time, **F64))
    return cfg, tt.device_consts(ops, **F64), tt.stack(states), tt.stack(scenes)


def two_scenario_fleets():
    """Two scenarios of the 4-robot fleet: the second jittered by 1e-3 and
    with its sphere 0.2 lower; states [2, 4, ...], scenes [2, ...]."""
    cfg, consts, scene, state = fleet()
    lower = scene._replace(points=scene.points - torch.tensor([0.0, 0.0, 0.2], dtype=torch.float64))
    second = state._replace(spline=state.spline + 1e-3)
    return cfg, consts, tt.stack([state, second]), tt.stack([scene, lower])


# ---------------------------------------------------------------------------
# the two-process job
# ---------------------------------------------------------------------------


def _cases(rank, out):
    """Every two-process case; rank 0 saves what the tests compare."""
    cpu = dict(device_type="cpu")
    mesh = sharded.make_mesh(WORLD, **cpu)
    group = mesh.get_group(sharded.ROBOT_AXIS)
    cfg, consts, scene, state = fleet()
    local = sharded.shard_robots(state, mesh)

    for coupled in (True, False):
        step = sharded.sharded_multi_step(consts, cfg, mesh, coupled)
        st, states, diags = local, [], []
        for _ in range(3):
            st, diag = step(st, scene)
            states.append(sharded.gather_robots(st, mesh))
            diags.append(diag)
        out[f"step {coupled}"] = (states, diags)
        # the select form (the CUDA graph's): collectives on every rank, no branch
        with graph.select_form():
            sel = step(local, scene)
        out[f"select {coupled}"] = (sharded.gather_robots(sel[0], mesh), sel[1])
        fused, it, gnorm = driver.solve_fused_multi(consts, cfg, local, scene, coupled,
                                                    max_iters=40, axis_name=group)
        out[f"fused {coupled}"] = (sharded.gather_robots(fused, mesh), it, gnorm)
    for method in ("eigh", "ladder"):
        fused, it, gnorm = driver.solve_fused_multi(consts, cfg.replace(psd_method=method), local,
                                                    scene, True, max_iters=9, axis_name=group)
        out[f"fused {method}"] = (sharded.gather_robots(fused, mesh), it, gnorm)
    # the host-stepped loop on this rank's robots, the plane caches sharded too
    ocfg = cfg.replace(optimal_plane=True)
    got, history = driver.solve_multi(consts, ocfg, local, scene, coupled=True, max_iters=4,
                                      axis_name=group)
    out["solve_multi optimal_plane"] = (sharded.gather_robots(got, mesh), history)

    ccfg, cconsts, far, splines, directions = conflict()
    try:
        sharded.shard_robots(splines[:3], mesh)
    except ValueError as exc:
        out["uneven"] = str(exc)
    mine = sharded.shard_robots((splines, directions), mesh)
    own = []
    real_any = multi._gany
    multi._gany = lambda x, axis_name: (own.append(bool(x.any())), real_any(x, axis_name))[1]
    try:
        steps = multi.decoupled_ccd_steps(cconsts, ccfg, *mine, far, axis_name=group)
    finally:
        multi._gany = real_any
    own_all = [None] * WORLD
    dist.all_gather_object(own_all, own)
    out["shrink"] = (sharded.gather_robots(steps, mesh), own_all)

    _, _, states2, scenes2 = two_scenario_fleets()
    for shape in ((2, 1), (1, 2)):
        mesh2 = sharded.make_mesh_2d(*shape, **cpu)
        states_local = sharded.shard_robots(states2, mesh2, sharded.SCENARIO_AXIS)
        states_local = tt.SolverState(*(sharded.shard_robots(x.transpose(0, 1), mesh2).transpose(0, 1)
                                        for x in states_local))
        scenes_local = sharded.shard_robots(scenes2, mesh2, sharded.SCENARIO_AXIS)
        got, diags = sharded.sharded_multi_step_2d(consts, cfg, mesh2, True)(states_local,
                                                                             scenes_local)
        got = tt.SolverState(*(sharded.gather_robots(x.transpose(0, 1), mesh2).transpose(0, 1)
                               for x in got))
        out[f"2d {shape}"] = (sharded.gather_robots(got, mesh2, sharded.SCENARIO_AXIS),
                              sharded.gather_robots(diags, mesh2, sharded.SCENARIO_AXIS))

    scfg, sconsts, sstates, sscenes = scenarios()
    smesh = sharded.make_mesh(WORLD, sharded.SCENARIO_AXIS, **cpu)
    solve = sharded.scenario_sharded_solver(sconsts, scfg, smesh, max_iters=6)
    res = solve(sharded.shard_robots(sstates, smesh, sharded.SCENARIO_AXIS),
                sharded.shard_robots(sscenes, smesh, sharded.SCENARIO_AXIS))
    out["scenarios"] = tuple(sharded.gather_robots(r, smesh, sharded.SCENARIO_AXIS) for r in res)

    from trajopt_tpu_torch.cli import multi as cli

    os.environ["WORLD_SIZE"] = str(WORLD)
    cli_dir = os.path.join(out["dir"], "cli")
    os.makedirs(cli_dir, exist_ok=True)
    out["cli rc"] = cli.main(CLI_ARGS + ["--mesh-devices", str(WORLD), "--result-dir", cli_dir,
                                         "--metrics", os.path.join(cli_dir, "m.jsonl")])


def _worker(rank, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD)
    out = {"dir": out_dir}
    try:
        _cases(rank, out)
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "results.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Run the two-process job once; its rank-0 results, by case."""
    out_dir = tmp_path_factory.mktemp("sharded")
    ctx = mp.start_processes(_worker, args=(str(out_dir / "store"), str(out_dir)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOB_TIMEOUT
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                pytest.fail(f"the two-process job did not finish in {JOB_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return torch.load(out_dir / "results.pt", weights_only=False), out_dir


def _close(got, want, rtol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.numpy() if torch.is_tensor(want) else np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1e-300))


def _close_trees(got, want, rtol):
    for a, b in zip(got, want, strict=True):
        _close(a, b, rtol)


# ---------------------------------------------------------------------------
# two processes against one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
def test_sharded_step_matches_one_process_and_jax(job, coupled):
    """Three steps on two ranks of two robots: the fleet's state and each
    step's diagnostics equal the one-process step's to rtol 1e-12, and the
    JAX package's (tests/test_sharded.py's fleet) to rtol 1e-8."""
    results, _ = job
    cfg, consts, scene, state = fleet()
    jcfg, jc, jscene, jstate = jax_fleet(uav_num=4)
    _close_trees(state, tt.from_numpy(jstate, **F64), 0.0)
    _close_trees(scene, tt.from_numpy(jscene, **F64), 0.0)
    jstate = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), jstate)
    for got, diag in zip(*results[f"step {coupled}"], strict=True):
        state, want = multi.multi_admm_step(consts, cfg, state, scene, coupled)
        jstate, jdiag = jmulti.multi_admm_step_jit(jc, jcfg, jstate, jscene, coupled)
        _close_trees(got, state, 1e-12)
        _close_trees(diag, want, 1e-12)
        _close_trees(tt.to_numpy(got), jstate, 1e-8)
        _close_trees(tt.to_numpy(diag), jdiag, 1e-8)


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
def test_sharded_select_form_equals_branch_form(job, coupled):
    """The sharded step in the select form (every collective on every rank,
    both sides of each branch) equals the branch form bit for bit."""
    results, _ = job
    got, diag = results[f"select {coupled}"]
    states, diags = results[f"step {coupled}"]
    for a, b in zip(got + diag, states[0] + diags[0], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
def test_sharded_fused_solve_matches_one_process(job, coupled):
    """`solve_fused_multi(axis_name=group)` to convergence on two ranks: the
    one-process run's iterations, state to rtol 1e-12."""
    results, _ = job
    got, it, gnorm = results[f"fused {coupled}"]
    cfg, consts, scene, state = fleet()
    want, want_it, want_gnorm = driver.solve_fused_multi(consts, cfg, state, scene, coupled,
                                                         max_iters=40)
    assert int(it) == int(want_it) < 40 and float(gnorm) < cfg.stop
    _close_trees(got, want, 1e-12)
    _close(gnorm, want_gnorm, 1e-10)


@pytest.mark.parametrize("method", ["eigh", "ladder"])
def test_sharded_fused_solve_with_psd_method_matches_one_process(job, method):
    """`solve_fused_multi(axis_name=group)` coupled with ``psd_method``
    "eigh" and "ladder", 9 iterations on two ranks (the repairs shift
    blocks from the fifth): the one-process run's iterations, state to
    rtol 1e-12."""
    results, _ = job
    got, it, gnorm = results[f"fused {method}"]
    cfg, consts, scene, state = fleet()
    want, want_it, want_gnorm = driver.solve_fused_multi(
        consts, cfg.replace(psd_method=method), state, scene, True, max_iters=9)
    assert int(it) == int(want_it)
    _close_trees(got, want, 1e-12)
    _close(gnorm, want_gnorm, 1e-10)


def test_sharded_solve_multi_with_plane_caches_matches_one_process(job):
    """`driver.solve_multi(axis_name=group)` with ``optimal_plane`` (each
    rank's obstacle and pair plane caches, pair slots counted over the
    fleet): the one-process solve's state to rtol 1e-12 and its history,
    wall times aside."""
    results, _ = job
    got, history = results["solve_multi optimal_plane"]
    cfg, consts, scene, state = fleet()
    want, want_history = driver.solve_multi(consts, cfg.replace(optimal_plane=True), state, scene,
                                            coupled=True, max_iters=4)
    _close_trees(got, want, 1e-12)
    assert len(history) == len(want_history) == 4
    for a, b in zip(history, want_history, strict=True):
        assert a.keys() == b.keys()
        for key in a.keys() - {"wall_ms"}:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-12)


def test_shrink_with_disagreeing_ranks_finishes(job):
    """Rank 0's robots are certified at step 1 and rank 1's are not: the
    shrink loop's predicate is the group's, so rank 0 keeps stepping with
    rank 1 (no all-gather left waiting) and the steps equal the one-process
    fixpoint's."""
    results, _ = job
    steps, own = results["shrink"]
    cfg, consts, far, splines, directions = conflict()
    want = multi.decoupled_ccd_steps(consts, cfg, splines, directions, far)
    assert torch.equal(steps, want)
    assert float(want[:2].amin()) == 1.0 and float(want[2:].amax()) < 0.2
    assert not any(own[0]) and own[1][0] and len(own[0]) == len(own[1]) > 1
    assert "do not divide" in results["uneven"]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["scenario2_robot1", "scenario1_robot2"])
def test_2d_mesh_matches_each_scenario(job, shape):
    """Two scenarios (own scenes) of four robots on a (scenario, robot) mesh
    of 2 x 1 and of 1 x 2: each scenario's state and diagnostics equal its
    one-process step's to rtol 1e-12."""
    results, _ = job
    got, diags = results[f"2d {shape}"]
    cfg, consts, states, scenes = two_scenario_fleets()
    for i in range(2):
        want, want_diag = multi.multi_admm_step(consts, cfg, tt.index(states, i),
                                                tt.index(scenes, i), True)
        _close_trees(tt.index(got, i), want, 1e-12)
        _close_trees(tt.index(diags, i), want_diag, 1e-12)


def test_scenario_sharded_solver_matches_each_solve(job):
    """Four scenarios, two a rank: each `solve_fused` result, bit for bit
    (no collective touches a scenario solve)."""
    results, _ = job
    states, its, gnorms = results["scenarios"]
    cfg, consts, sstates, sscenes = scenarios()
    for i in range(4):
        want, it, gnorm = driver.solve_fused(consts, cfg, tt.index(sstates, i),
                                             tt.index(sscenes, i), max_iters=6)
        for a, b in zip(tt.index(states, i), want):
            assert torch.equal(a, b)
        assert int(its[i]) == int(it) and torch.equal(gnorms[i], gnorm)


def test_cli_mesh_devices_matches_unsharded(job, tmp_path, capsys):
    """``cli.multi --cpu --mesh-devices 2`` under two processes writes the
    unsharded CLI's result file (the running time aside); rank 0 alone
    writes."""
    results, out_dir = job
    from trajopt_tpu_torch.cli import multi as cli

    assert results["cli rc"] == 0
    assert cli.main(CLI_ARGS + ["--result-dir", str(tmp_path),
                                "--metrics", str(tmp_path / "m.jsonl")]) == 0
    name = "cross_synthetic_result_file_admm.txt"
    got = (out_dir / "cli" / name).read_text().splitlines()
    want = (tmp_path / name).read_text().splitlines()
    assert got[0] == want[0] == "iter: 4" and got[2:] == want[2:]
    assert got[1].startswith("running time: ")
    rows = [[json.loads(line) for line in (d / "m.jsonl").read_text().splitlines()]
            for d in (out_dir / "cli", tmp_path)]
    for a, b in zip(*rows, strict=True):
        assert a.keys() == b.keys()
        for key in a.keys() - {"wall_ms"}:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-12)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def test_single_process_mesh_without_torchrun(monkeypatch):
    """With no torchrun environment `init_distributed()` joins nothing;
    `make_mesh(1)` then makes a single-rank gloo group itself, on which the
    sharded step equals `multi_admm_step` bit for bit; grouped coupled
    batching (single-shard), a scenario solver on a mesh with no scenario
    axis and a sharded loop with a checkpointer are refused."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    sharded.init_distributed(device_type="cpu")
    assert not dist.is_initialized()
    try:
        mesh = sharded.make_mesh(1, device_type="cpu")
        assert dist.get_world_size() == 1 and mesh.size() == 1
        cfg, consts, scene, state = fleet()
        for coupled in (True, False):
            got = sharded.sharded_multi_step(consts, cfg, mesh, coupled)(state, scene)
            want = multi.multi_admm_step(consts, cfg, state, scene, coupled)
            for a, b in zip(got[0] + got[1], want[0] + want[1]):
                assert torch.equal(a, b)
        with pytest.raises(ValueError, match="single-shard"):
            multi.multi_admm_step(consts, cfg, state, scene, True, groups=2,
                                  axis_name=mesh.get_group(sharded.ROBOT_AXIS))
        with pytest.raises(ValueError, match="needs 2 devices"):
            sharded.make_mesh_2d(2, 1, device_type="cpu")
        with pytest.raises(ValueError, match="'scenario' axis"):
            sharded.scenario_sharded_solver(consts, cfg, mesh)
        with pytest.raises(ValueError, match="no checkpointer"):
            driver.solve_multi(consts, cfg, state, scene, axis_name=mesh.get_group(
                sharded.ROBOT_AXIS), checkpointer=object())
    finally:
        dist.destroy_process_group()


def test_cli_mesh_devices_1_without_torchrun(tmp_path, monkeypatch):
    """``--mesh-devices 1`` with no torchrun environment runs on the
    single-rank group of `make_mesh(1)`, writes the unsharded CLI's result
    and metrics, and leaves no process group behind; a job whose
    WORLD_SIZE is not N raises."""
    from trajopt_tpu_torch.cli import multi as cli

    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    runs = {}
    for name, extra in (("sharded", ["--mesh-devices", "1"]), ("plain", [])):
        out = tmp_path / name
        assert cli.main(CLI_ARGS + extra + ["--result-dir", str(out),
                                            "--metrics", str(tmp_path / f"{name}.jsonl")]) == 0
        assert not dist.is_initialized()
        lines = (out / "cross_synthetic_result_file_admm.txt").read_text().splitlines()
        rows = [json.loads(line) for line in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        runs[name] = (lines[:1] + lines[2:], [{k: v for k, v in r.items() if k != "wall_ms"}
                                              for r in rows])
    assert runs["sharded"] == runs["plain"]
    with pytest.raises(ValueError, match="WORLD_SIZE is 1"):
        cli.main(CLI_ARGS + ["--mesh-devices", "2", "--result-dir", str(tmp_path / "x")])
