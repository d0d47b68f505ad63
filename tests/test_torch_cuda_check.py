"""tools/cuda_check.py, the port's congested-step check, on the CPU: its
problem against `__graft_entry__._build_problem`, its direction, clearances
and energies against tools/tpu_check.py's JAX helpers in float64 on one
warm state, the whole probe in CPU float32, and its refusals."""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from trajopt_tpu import types as jtypes
from trajopt_tpu.ops import energies as jen
from trajopt_tpu.ops import geometry as jgeo
from trajopt_tpu.solver import multi as jmulti
from trajopt_tpu_torch import types as tt

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
F64_CONGESTED_ITER = 13    # the port's CPU float64 warm-up (and TPU_CHECK.json's)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cc = _load("cuda_check")
tpu_check = _load("tpu_check")


@pytest.fixture(scope="module")
def jax_problem():
    """tools/tpu_check.py's problem, built by the JAX package (float64)."""
    return __graft_entry__._build_problem(uav_num=8, n_pieces=4, res=8, n_points=2000,
                                          max_planes=16, max_self=4, max_ccd=16)


def test_build_is_the_graft_entry_problem(jax_problem):
    """The points, every field of the start state and of the config, exactly."""
    jcfg, _, jscene, jstate = jax_problem
    cfg, _, scene, state = cc.build(CPU, torch.float64)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(scene.points.numpy(), np.asarray(jscene.points))
    np.testing.assert_array_equal(scene.mask.numpy(), np.asarray(jscene.mask))
    assert state._fields == jstate._fields
    for got, want in zip(state, jstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def warm64():
    """The port's CPU float64 warm state (the state before the first
    congested step) and its problem."""
    cfg, consts, scene, state = cc.build(CPU, torch.float64)
    warm, it, _ = cc.warm_to_congestion(consts, cfg, state, scene)
    return cfg, consts, scene, warm, it


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_direction_clearances_and_energies_match_tpu_check(warm64, jax_problem, monkeypatch):
    """tools/tpu_check.py's `_direction_and_planes`, `_f64_clearances` and
    its fleet energy (jitted) on JAX's CPU float64, handed the port's warm
    state: ds, dt, gnorm, step0 at rtol 1e-8, equal plane counts,
    clearances and energies within 1e-8 relative."""
    # `_f64_clearances` runs eagerly (it returns Python floats); its GJK
    # batches jitted give the same bits in half the time
    monkeypatch.setattr(jgeo, "batched_origin_dist",
                        jax.jit(jgeo.batched_origin_dist, static_argnums=(1, 2)))
    cfg, consts, scene, warm, it = warm64
    assert it == F64_CONGESTED_ITER
    jcfg, jconsts, jscene, _ = jax_problem
    jwarm = jtypes.SolverState(*(jnp.asarray(x.numpy()) for x in warm))

    got = cc.direction_and_planes(cfg, consts, scene, warm)
    want = jax.jit(tpu_check._direction_and_planes, static_argnums=0)(jcfg, jconsts, jscene, jwarm)
    for g, w in zip((got.ds, got.dt, got.gnorm, got.step0), (want[0], want[1], want[2], want[4])):
        _close(g.numpy(), w, 1e-8)
    assert int(got.n_planes) == int(want[3]) > 0
    assert float(got.step0) < 1.0

    # the card's post step stands in as the port's CPU float64 step here
    post, _ = cc.multi.multi_admm_step(consts, cfg, warm, scene, coupled=True)
    clr = cc.f64_clearances(cfg, consts, scene, post.spline)
    jclr = tpu_check._f64_clearances(jcfg, jconsts, jscene, jnp.asarray(post.spline.numpy()))
    _close(clr, jclr, 1e-8)

    @jax.jit
    def jfleet_energies(warm, post_spline, post_time):
        """tools/tpu_check.py's ``fleet_energy`` (the oracle's planes) at
        the warm and the post-step state."""
        planes, _ = jmulti._all_planes(jconsts, jcfg, warm, jscene, None)

        def fleet_energy(spline, ptime):
            def one(st, pl, s, t):
                ev = jen.spline_energy(jconsts, jcfg, st, pl, spline=s, piece_time=t)
                return jnp.where(ev.infeasible, jnp.inf, ev.value)

            return jnp.sum(jax.vmap(one)(warm, planes, spline, ptime))

        return fleet_energy(warm.spline, warm.piece_time), fleet_energy(post_spline, post_time)

    want = jfleet_energies(jwarm, jnp.asarray(post.spline.numpy()),
                           jnp.asarray(post.piece_time.numpy()))
    got = [cc.fleet_energy(cfg, consts, warm, got.planes, s, t)
           for s, t in ((warm.spline, warm.piece_time), (post.spline, post.piece_time))]
    _close(got, want, 1e-8)
    assert np.all(np.isfinite(got)) and got[1] < got[0]


@pytest.mark.parametrize("psd_method", cc.PSD_METHODS)
def test_cpu_rehearsal_passes(warm64, psd_method, tmp_path, capsys):
    """`python tools/cuda_check.py --cpu`: the probe end to end in CPU
    float32 through the plain versions; every entry ok, kernels_active
    "not on a card", the warm iteration the float64 one or next to it, the
    report written to --out and its ok values on the first line."""
    out = tmp_path / "report.json"
    assert cc.main(["--cpu", "--psd-method", psd_method, "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == {
        k: v["ok"] for k, v in report["deviations"].items()}
    assert report["psd_method"] == psd_method and report["dtype"] == "float32"
    assert report["failed"] == [] and report["all_ok"]
    entries = report["deviations"]
    assert entries.pop("kernels_active")["ok"] == cc.NOT_ON_A_CARD
    assert all(e["ok"] is True for e in entries.values()), entries
    assert abs(report["warm_iter"] - warm64[4]) <= 1
    assert entries["n_planes"]["card"] > 0 and entries["ccd_refine_active"]["card_ccd_step"] < 1


def test_warm_up_that_never_congests_raises(warm64, monkeypatch):
    """With MAX_WARM below the congestion iteration the probe refuses to
    run instead of passing vacuously."""
    monkeypatch.setattr(cc, "MAX_WARM", warm64[4] - 1)
    cfg, consts, scene, state = cc.build(CPU, torch.float32)
    with pytest.raises(cc.NotCongested, match="vacuous"):
        cc.warm_to_congestion(consts, cfg, state, scene)


def test_cli_refuses_to_run_without_a_card(monkeypatch):
    """Without --cpu and without a CUDA device the tool raises; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(cc, "probe", lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="CUDA device"):
        cc.main([])
    with pytest.raises(RuntimeError, match="CUDA device"):
        cc.main(["--psd-method", "eigh"])
    assert ran == []
