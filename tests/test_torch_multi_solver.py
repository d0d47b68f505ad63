"""The torch port's multi-robot step, driver and CLI against the JAX package
on the CPU, in float64, on the tests/test_multi.py fixture; and the guard
that the port imports nothing of the JAX package."""

import ast
import dataclasses
import functools
import pathlib
import warnings

import numpy as np
import pytest
import torch

from tests.test_multi import make_problem
from trajopt_tpu.solver import driver as jdriver
from trajopt_tpu.solver import multi as jmulti
from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.solver import driver, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
REPO = pathlib.Path(__file__).resolve().parent.parent


def port_cfg(cfg):
    """The port's TrajOptConfig with the JAX one's fields."""
    return tconfig.TrajOptConfig(**dataclasses.asdict(cfg))


def _close(got, want, rtol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1e-300))


@pytest.fixture(scope="module")
def fleet():
    """Three robots, res 4, 3 pieces, with the sphere of obstacles."""
    cfg, ops, jc, jscene, jstate = make_problem(uav_num=3, with_obstacles=True)
    conv = functools.partial(tt.from_numpy, **F64)
    return cfg, jc, jscene, jstate, conv(jc), conv(jscene)


@pytest.mark.parametrize("start", ["init", "stepped"])
@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
def test_three_multi_steps_match_jax(fleet, coupled, start):
    """From the initial state and from the fourth iterate: state and StepDiag
    after each of three steps, rtol 1e-8, with live robot-pair planes."""
    cfg, jc, jscene, jstate, consts, scene = fleet
    if start == "stepped":
        for _ in range(4):
            jstate, _ = jmulti.multi_admm_step_jit(jc, cfg, jstate, jscene, coupled)
    state = tt.from_numpy(jstate, **F64)
    tcfg = port_cfg(cfg)
    pair_planes = 0
    for _ in range(3):
        jstate, jdiag = jmulti.multi_admm_step_jit(jc, cfg, jstate, jscene, coupled)
        state, diag = multi.multi_admm_step(consts, tcfg, state, scene, coupled)
        for got, want in zip(tt.to_numpy(state), jstate):
            _close(got, want, 1e-8)
        for got, want in zip(tt.to_numpy(diag), jdiag):
            _close(got, want, 1e-8)
        planes, _ = multi._all_planes(consts, tcfg, state, scene)
        pair_planes += int(planes.mask[..., cfg.max_planes:].sum())
    assert pair_planes > 0


def test_solve_multi_matches_jax():
    """Two robots to convergence: the same iterations and plane counts."""
    cfg, ops, jc, jscene, jstate = make_problem(uav_num=2, with_obstacles=True)
    jfinal, jhist = jdriver.solve_multi(jc, cfg, jstate, jscene, coupled=True, max_iters=80)
    state, hist = driver.solve_multi(
        tt.from_numpy(jc, **F64), port_cfg(cfg), tt.from_numpy(jstate, **F64),
        tt.from_numpy(jscene, **F64), coupled=True, max_iters=80,
    )
    assert len(hist) == len(jhist)
    assert hist[-1]["gnorm"] < cfg.stop
    assert [h.keys() for h in hist] == [h.keys() for h in jhist]
    assert [h["n_planes"] for h in hist] == [h["n_planes"] for h in jhist]
    np.testing.assert_allclose(state.spline.numpy(), np.asarray(jfinal.spline), atol=1e-6)
    np.testing.assert_allclose(state.piece_time.numpy(), np.asarray(jfinal.piece_time), atol=1e-6)


def test_init_multi_state_matches_jax():
    """The stacked initial fleet state equals the reference's, from the
    waypoints tests/test_multi.py::make_problem builds."""
    cfg, ops, _, _, jstate = make_problem(uav_num=3)
    wps = []
    for i in range(3):
        sgn = 1 if i % 2 == 0 else -1
        s = np.array([sgn * 3.0, 0.12 * (i // 2), 0.26 * i])
        e = np.array([-sgn * 3.0, 0.12 * (i // 2), 0.26 * i])
        t = np.linspace(0, 1, 4)[:, None]
        wps.append(s * (1 - t) + e * t)
    state = multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64)
    for got, want in zip(state, jstate):
        _close(got, want, 0.0)


def test_colliding_start_warns():
    """tests/test_multi.py::test_infeasible_init_warns on the port."""
    cfg = tconfig.TrajOptConfig(res=2, max_planes=4, max_self_planes=2, max_ccd_candidates=4,
                                ks=1e-3)
    from trajopt_tpu_torch.ops import splines as sp

    wps = []
    for i in range(2):
        s = np.array([(1 if i % 2 == 0 else -1) * 3.0, 0.0, 0.26 * i])
        t = np.linspace(0, 1, 3)[:, None]
        wps.append(s * (1 - t) + (-s) * t)
    ops = sp.build_spline_ops(2, cfg.res)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        driver.solve_multi(tt.device_consts(ops, **F64), cfg,
                           multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64),
                           tt.make_scene(np.full((8, 3), 100.0), **F64), coupled=True,
                           max_iters=2)
    assert any("pairwise robot clearance" in str(r.message) for r in rec)


def test_cli_multi_cpu(tmp_path, capsys):
    from trajopt_tpu_torch.cli import multi as cli

    rc = cli.main(["--scene", "cross", "--uav-num", "2", "--cpu", "--x64", "--n-points", "300",
                   "--max-iters", "3", "--result-dir", str(tmp_path),
                   "--metrics", str(tmp_path / "m.jsonl")])
    assert rc == 0
    text = (tmp_path / "cross_synthetic_result_file_admm.txt").read_text().splitlines()
    assert text[0] == "iter: 3" and text[2] == "point cloud size: 300"
    out = capsys.readouterr().out
    for key in ("uav_num: 2  mode: decoupled", "iter: 3", "uav 0: ccd time", "uav 1: ccd time"):
        assert key in out
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 3


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_the_jax_package():
    """No module of trajopt_tpu_torch and no line of chip_smoke.py imports
    jax or trajopt_tpu (the card's machine has neither)."""
    files = sorted((REPO / "trajopt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    assert REPO / "trajopt_tpu_torch" / "runtime" / "checkpoint.py" in files
    bad = [
        f"{f.relative_to(REPO)}: {name}"
        for f in files for name in _imported_modules(f)
        if name.split(".")[0] in ("jax", "jaxlib", "trajopt_tpu")
    ]
    assert not bad, bad
