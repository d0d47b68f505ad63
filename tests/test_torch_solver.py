"""The torch port's ADMM step, driver and CLI against the JAX package on the
CPU, in float64, on the sphere fixture of tests/test_admm_single.py."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import types as jt
from trajopt_tpu.config import TrajOptConfig
from trajopt_tpu.ops import splines as sp
from trajopt_tpu.scenes import generators as gen
from trajopt_tpu.solver import admm as jadmm
from trajopt_tpu.solver import driver as jdriver
from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.solver import admm, driver

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_cfg(cfg):
    """The port's TrajOptConfig with the JAX one's fields."""
    return tconfig.TrajOptConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def fixture():
    cfg = TrajOptConfig(res=4, max_planes=16, max_ccd_candidates=16)
    cloud = gen.sphere_scene(n_points=400, radius=1.0, seed=1)
    wp = np.array([[-3.0, 0.0, 0.0], [-1.5, 1.6, 0.0], [0.0, 1.8, 0.0],
                   [1.5, 1.6, 0.0], [3.0, 0.0, 0.0]])
    ops = sp.build_spline_ops(len(wp) - 1, cfg.res)
    # strongly typed copy of the initial state (same values): init_state's
    # weakly typed t_slack would make JAX compile admm_step a second time
    jstate0 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                           jt.init_state(ops, wp, cfg.init_piece_time))
    jax_side = (jt.device_consts(ops), jt.make_scene(cloud), jstate0)
    jfinal, jhist = jdriver.solve(jax_side[0], cfg, jstate0, jax_side[1], max_iters=60,
                                  validate_init=False)
    return cfg, ops, wp, cloud, jax_side, jfinal, jhist


def _close(got, want, rtol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1e-300))


@pytest.mark.parametrize("start", ["init", "planes_live"])
def test_three_admm_steps_match_jax(fixture, start):
    """From the initial state, and from the first iterate with live barrier
    planes: state and StepDiag after each of three steps, rtol 1e-8."""
    cfg, ops, wp, cloud, (jc, jscene, jstate), _, jhist = fixture
    if start == "planes_live":
        k = next(h["iter"] for h in jhist if h["n_planes"] > 0)
        jstate, _ = jdriver.solve(jc, cfg, jstate, jscene, max_iters=k, validate_init=False)
    consts, scene = tt.from_numpy(jc, **F64), tt.from_numpy(jscene, **F64)
    state = tt.from_numpy(jstate, **F64)
    live = 0
    for _ in range(3):
        jstate, jdiag = jadmm.admm_step(jc, cfg, jstate, jscene)
        state, diag = admm.admm_step(consts, port_cfg(cfg), state, scene)
        for got, want in zip(tt.to_numpy(state), jstate):
            _close(got, want, 1e-8)
        for got, want in zip(tt.to_numpy(diag), jdiag):
            _close(got, want, 1e-8)
        live += int(diag.n_planes)
    assert live > 0 or start == "init"


def test_solve_matches_jax(fixture):
    cfg, ops, wp, cloud, _, jfinal, jhist = fixture
    state, hist = driver.solve(
        tt.device_consts(ops, **F64), port_cfg(cfg),
        tt.init_state(ops, wp, cfg.init_piece_time, **F64),
        tt.make_scene(cloud, **F64), max_iters=60,
    )
    assert len(hist) == len(jhist)
    assert hist[-1]["gnorm"] < cfg.stop
    assert [h.keys() for h in hist] == [h.keys() for h in jhist]
    assert [h["n_planes"] for h in hist] == [h["n_planes"] for h in jhist]
    np.testing.assert_allclose(state.spline.numpy(), np.asarray(jfinal.spline), atol=1e-6)
    np.testing.assert_allclose(float(state.piece_time), float(jfinal.piece_time), atol=1e-6)


def _three_steps_with(fixture, method):
    """Three steps with ``psd_method=method`` from the first iterate with
    live planes against the JAX package's, state and StepDiag at rtol
    1e-8; a spline block the steps repair is indefinite."""
    from trajopt_tpu_torch.ops import gradients as gr

    cfg, ops, wp, cloud, (jc, jscene, jstate), _, jhist = fixture
    k = next(h["iter"] for h in jhist if h["n_planes"] > 0)
    jstate, _ = jdriver.solve(jc, cfg, jstate, jscene, max_iters=k, validate_init=False)
    cfg = cfg.replace(psd_method=method)
    consts, scene = tt.from_numpy(jc, **F64), tt.from_numpy(jscene, **F64)
    state = tt.from_numpy(jstate, **F64)
    least = float("inf")
    for _ in range(3):
        jstate, jdiag = jadmm.admm_step(jc, cfg, jstate, jscene)
        _, h = gr.piece_grads_and_hessians(consts, port_cfg(cfg), state.spline, state.piece_time,
                                           admm.separate_planes(consts, port_cfg(cfg), state.spline,
                                                                scene)[0],
                                           *state[2:], repair=False)
        least = min(least, float(torch.linalg.eigvalsh(h).min()))
        state, diag = admm.admm_step(consts, port_cfg(cfg), state, scene)
        for got, want in zip(tt.to_numpy(state), jstate):
            _close(got, want, 1e-8)
        for got, want in zip(tt.to_numpy(diag), jdiag):
            _close(got, want, 1e-8)
    assert int(diag.n_planes) > 0
    assert least < 0


def test_three_admm_steps_with_eigh_match_jax(fixture):
    """``psd_method="eigh"`` (the reference's eigenvalue shift, then a plain
    Cholesky solve of the slack step): three steps from the first iterate
    with live planes, rtol 1e-8."""
    _three_steps_with(fixture, "eigh")


def test_three_admm_steps_with_ladder_match_jax(fixture):
    """``psd_method="ladder"`` (the Cholesky shift ladder on the spline and
    the slack blocks, then a plain Cholesky solve of the slack step): three
    steps from the first iterate with live planes, rtol 1e-8."""
    _three_steps_with(fixture, "ladder")


def test_steps_restore_the_callers_tf32_flags():
    """Each step turns TF32 off for itself only (the reference scopes its
    "highest" matmul precision to the step): flags the caller set to True
    are True again after one step of each kind."""
    from trajopt_tpu_torch.solver import multi

    cfg = tconfig.TrajOptConfig(res=2, max_planes=4, max_self_planes=2, max_ccd_candidates=4,
                                ks=1e-3, optimal_plane=True)
    ops = sp.build_spline_ops(2, cfg.res)
    kw = dict(device="cpu", dtype=torch.float32)
    consts = tt.device_consts(ops, **kw)
    scene = tt.make_scene(gen.sphere_scene(n_points=100, radius=1.0, seed=1), **kw)
    wp = np.array([[-3.0, 0, 0], [0, 1.8, 0], [3.0, 0, 0]])
    state = tt.init_state(ops, wp, 20.0, **kw)
    fleet = multi.init_multi_state(ops, [wp, wp + np.array([0.0, 0.0, 0.26])], 20.0, **kw)
    steps = {
        "admm_step": lambda: admm.admm_step(consts, cfg, state, scene),
        "admm_step_cached": lambda: admm.admm_step_cached(
            consts, cfg, state, scene,
            tt.empty_plane_cache(consts.piece_num, consts.res, cfg.max_planes, **kw)),
        "multi_admm_step": lambda: multi.multi_admm_step(consts, cfg, fleet, scene, True),
        "multi_admm_step_cached": lambda: multi.multi_admm_step_cached(
            consts, cfg, fleet, scene, False, multi.init_multi_caches(cfg, consts, 2, **kw)),
    }
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        for name, step in steps.items():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            step()
            assert torch.backends.cuda.matmul.allow_tf32, name
            assert torch.backends.cudnn.allow_tf32, name
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_port_runs_without_jax():
    """Importing the port and running one single-robot and one multi-robot
    CPU step loads neither jax nor any module of trajopt_tpu (the GPU
    machine has no JAX installed, and the port keeps its own copies)."""
    code = """
import sys
import numpy as np, torch
import trajopt_tpu_torch
from trajopt_tpu_torch import metrics, types as tt
from trajopt_tpu_torch.cli import multi as cli_multi, single
from trajopt_tpu_torch.config import TrajOptConfig
from trajopt_tpu_torch.ops import splines as sp
from trajopt_tpu_torch.scenes import generators as gen
from trajopt_tpu_torch.solver import admm, driver, multi
from trajopt_tpu_torch.runtime import checkpoint
cfg = TrajOptConfig(res=4, max_planes=16, max_ccd_candidates=16)
cloud = gen.sphere_scene(n_points=200, radius=1.0, seed=1)
wp = np.array([[-3.0, 0, 0], [0, 1.8, 0], [3.0, 0, 0]])
ops = sp.build_spline_ops(2, cfg.res)
kw = dict(device="cpu", dtype=torch.float32)
consts, scene = tt.device_consts(ops, **kw), tt.make_scene(cloud, **kw)
state, diag = admm.admm_step(consts, cfg, tt.init_state(ops, wp, 20.0, **kw), scene)
assert torch.isfinite(diag.gnorm)
wps = [wp + np.array([0.0, 0.0, 0.26 * i]) for i in range(2)]
fleet = multi.init_multi_state(ops, wps, 20.0, **kw)
for coupled in (True, False):
    fleet_next, diag = multi.multi_admm_step(consts, cfg.replace(ks=1e-3), fleet, scene, coupled)
    assert torch.isfinite(diag.gnorm) and int(diag.n_planes) > 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "trajopt_tpu"))
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_cli_single_cpu(tmp_path, capsys):
    from trajopt_tpu_torch.cli import single

    rc = single.main(["--scene", "sphere", "--cpu", "--x64", "--n-points", "400",
                      "--max-iters", "3", "--result-dir", str(tmp_path),
                      "--metrics", str(tmp_path / "m.jsonl")])
    assert rc == 0
    text = (tmp_path / "sphere_synthetic_result_file_admm.txt").read_text().splitlines()
    assert text[0] == "iter: 3" and text[2] == "point cloud size: 400"
    assert text[1].startswith("running time: ")
    out = capsys.readouterr().out
    for key in ("iter: 3", "ccd time:", "ccd len:", "min curve clearance:"):
        assert key in out
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 3
