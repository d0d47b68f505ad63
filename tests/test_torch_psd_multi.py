"""The multi-robot step of the torch port with ``psd_method="eigh"`` and
``"ladder"`` against the JAX package's, on the CPU in float64, on the
tests/test_multi.py fixture (tests/test_torch_multi_solver.py holds the
default GMW repair)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from tests.test_multi import make_problem
from trajopt_tpu.solver import multi as jmulti
from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import gradients as gr
from trajopt_tpu_torch.solver import multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


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


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
@pytest.mark.parametrize("method", ["eigh", "ladder"])
def test_three_multi_steps_with_psd_method_match_jax(monkeypatch, fleet, method, coupled):
    """From the fifth iterate (four steps of the JAX package with the same
    method), three steps: state and StepDiag after each at rtol 1e-8, as
    the default method's steps are held; a fleet block the steps repair is
    indefinite."""
    cfg, jc, jscene, jstate, consts, scene = fleet
    cfg = dataclasses.replace(cfg, psd_method=method)
    step = jax.jit(jmulti.multi_admm_step, static_argnums=(1, 4))
    for _ in range(4):
        jstate, _ = step(jc, cfg, jstate, jscene, coupled)
    state = tt.from_numpy(jstate, **F64)
    tcfg = tconfig.TrajOptConfig(**dataclasses.asdict(cfg))
    least = []
    real = gr.apply_psd_repair

    def spy(c, h):
        least.append(float(torch.linalg.eigvalsh(h).min()))
        return real(c, h)

    monkeypatch.setattr(gr, "apply_psd_repair", spy)
    for _ in range(3):
        jstate, jdiag = step(jc, cfg, jstate, jscene, coupled)
        state, diag = multi.multi_admm_step(consts, tcfg, state, scene, coupled)
        for got, want in zip(tt.to_numpy(state), jstate):
            _close(got, want, 1e-8)
        for got, want in zip(tt.to_numpy(diag), jdiag):
            _close(got, want, 1e-8)
    assert min(least) < 0
