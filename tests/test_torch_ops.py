"""The torch port's ops against the JAX package on the CPU, in float64:
energies, per-piece gradients/Hessians, the reduced KKT direction, the
broad phase and the analytic max-step CCD.  Inputs come from numpy seeds
and go to both packages (through `trajopt_tpu_torch.types.from_numpy`)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import types as jt
from trajopt_tpu.config import TrajOptConfig
from trajopt_tpu.ops import broadphase as jbp
from trajopt_tpu.ops import ccd as jccd
from trajopt_tpu.ops import energies as jen
from trajopt_tpu.ops import geometry as jgeo
from trajopt_tpu.ops import gradients as jgr
from trajopt_tpu.ops import splines as sp
from trajopt_tpu.scenes import generators as gen
from trajopt_tpu.solver import admm as jadmm
from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import broadphase as bp
from trajopt_tpu_torch.ops import ccd
from trajopt_tpu_torch.ops import energies as en
from trajopt_tpu_torch.ops import gradients as gr
from trajopt_tpu_torch.solver import admm

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
CFG = TrajOptConfig(res=4, max_planes=16, max_ccd_candidates=16)
TCFG = tconfig.TrajOptConfig(**dataclasses.asdict(CFG))   # the port's, same fields


def _close(got, want, rtol=1e-10):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1e-300))


def _problem(pieces, seed, piece_time=20.0):
    """JAX and torch copies of one perturbed sphere-scene state with random
    plane tables (some live, some in the barrier band, some infeasible)."""
    rng = np.random.default_rng(seed)
    cloud = gen.sphere_scene(n_points=400, radius=1.0, seed=1)
    wp = np.stack([np.linspace(-3, 3, pieces + 1),
                   1.6 + 0.2 * np.sin(np.linspace(0, np.pi, pieces + 1)),
                   np.zeros(pieces + 1)], axis=1)
    ops = sp.build_spline_ops(pieces, CFG.res)
    js = jt.init_state(ops, wp, 20.0)
    js = js._replace(
        spline=js.spline + rng.normal(scale=0.05, size=js.spline.shape),
        piece_time=jnp.asarray(piece_time),
        p_slack=js.p_slack + rng.normal(scale=0.05, size=js.p_slack.shape),
        t_slack=js.t_slack + rng.normal(scale=0.5, size=js.t_slack.shape),
        p_lambda=jnp.asarray(rng.normal(scale=0.1, size=js.p_lambda.shape)),
        t_lambda=jnp.asarray(rng.normal(scale=0.1, size=js.t_lambda.shape)),
    )
    jc = jt.device_consts(ops)
    hull = np.asarray(jen.seg_cps(jc, js.spline))                 # [P,R,n,3]
    k = CFG.max_planes
    c = rng.normal(size=hull.shape[:2] + (k, 3))
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    s_min = np.einsum("prjd,prkd->prkj", hull, c).min(-1)
    d = -s_min + rng.uniform(-0.02, 0.15, size=s_min.shape)
    mask = rng.random(s_min.shape) < 0.5
    jp = jt.Planes(c=jnp.asarray(c), d=jnp.asarray(d), mask=jnp.asarray(mask))
    js_scene = jt.make_scene(cloud)
    conv = functools.partial(tt.from_numpy, **F64)
    return ops, (jc, js, jp, js_scene), (conv(jc), conv(js), conv(jp), conv(js_scene))


@pytest.mark.parametrize("piece_time", [20.0, 1.6, 0.9])
def test_energies_match_jax(piece_time):
    ops, (jc, js, jp, _), (c, s, p, _) = _problem(4, 0, piece_time)
    _close(en.piece_cps(c, s.spline), jen.piece_cps(jc, js.spline))
    _close(en.seg_cps(c, s.spline), jen.seg_cps(jc, js.spline))
    _close(en.plane_distances(en.seg_cps(c, s.spline), p),
           jen.plane_distances(jen.seg_cps(jc, js.spline), jp))
    for name in ("plane_barrier_energy",):
        got, want = getattr(en, name)(c, TCFG, s.spline, p), getattr(jen, name)(jc, CFG, js.spline, jp)
        _close(got.value, want.value)
        _close(got.infeasible, want.infeasible)
    got, want = en.bound_energy(c, TCFG, s.spline, s.piece_time), jen.bound_energy(jc, CFG, js.spline, js.piece_time)
    _close(got.value, want.value)
    _close(got.infeasible, want.infeasible)
    pcs = en.piece_cps(c, s.spline)
    _close(en.dynamic_energy(c, TCFG, pcs, s.t_slack[:, None, None]),
           jen.dynamic_energy(jc, CFG, jen.piece_cps(jc, js.spline), js.t_slack[:, None, None]))
    _close(en.consensus_terms(c, TCFG, s.spline, *s[1:]), jen.consensus_terms(jc, CFG, js.spline, *js[1:]))
    got, want = en.spline_energy(c, TCFG, s, p), jen.spline_energy(jc, CFG, js, jp)
    _close(got.value, want.value)
    _close(got.infeasible, want.infeasible)
    cs = torch.einsum("pij,pjd->pid", c.convert, pcs)
    jcs = jnp.einsum("pij,pjd->pid", jc.convert, jen.piece_cps(jc, js.spline))
    _close(en.slack_energy(c, TCFG, cs, s.piece_time, s.p_slack, s.t_slack, s.p_lambda, s.t_lambda),
           jen.slack_energy(jc, CFG, jcs, js.piece_time, js.p_slack, js.t_slack, js.p_lambda, js.t_lambda))
    got = en.true_objective(c, TCFG, s.spline, s.piece_time, p)
    want = jen.true_objective(jc, CFG, js.spline, js.piece_time, jp)
    for key in want:
        _close(got[key], want[key])


def test_trial_tables_match_jax():
    ops, (jc, js, jp, _), (c, s, p, _) = _problem(4, 1, 1.6)
    rng = np.random.default_rng(2)
    direction = rng.normal(scale=0.1, size=(ops.trajectory_num, 3))
    dt = np.asarray([-0.3])
    su = tt.SolverState(*(x[None] for x in s))
    pu = tt.Planes(*(x[None] for x in p))
    tab = en.build_trial_tables(c, TCFG, su, pu, torch.as_tensor(direction[None], **F64),
                                torch.as_tensor(dt, **F64))
    jtab = jen.build_trial_tables(
        jc, CFG, jax.tree.map(lambda x: x[None], js), jax.tree.map(lambda x: x[None], jp),
        jnp.asarray(direction[None]), jnp.asarray(dt),
    )
    for got, want in zip(tab, jtab):
        _close(got, want)
    for step in (0.0, 0.1, 0.5, 1.0, 3.0):
        _close(en.trial_energy(c, TCFG, tab, torch.tensor([step], **F64)),
               jen.trial_energy(jc, CFG, jtab, jnp.asarray([step])))


@pytest.mark.parametrize("grad_mode", ["analytic", "autodiff"])
def test_piece_grads_and_hessians_match_jax(grad_mode):
    cfg = CFG.replace(grad_mode=grad_mode)
    tcfg = TCFG.replace(grad_mode=grad_mode)
    ops, (jc, js, jp, _), (c, s, p, _) = _problem(4, 3, 1.6)
    jp = jp._replace(d=jp.d + 0.02)            # every live plane strictly feasible
    p = p._replace(d=p.d + 0.02)
    jfn = jax.jit(jgr.piece_grads_and_hessians, static_argnums=(1, 9))
    for repair in (False, True):
        want = jfn(jc, cfg, js.spline, js.piece_time, jp, *js[2:], repair)
        got = gr.piece_grads_and_hessians(c, tcfg, s.spline, s.piece_time, p, *s[2:], repair=repair)
        for g, w in zip(got, want):
            _close(g, w, rtol=1e-9)


def test_psd_methods_other_than_gmw_are_refused():
    with pytest.raises(NotImplementedError, match="psd_method"):
        gr.apply_psd_repair(TCFG.replace(psd_method="eigh"), torch.eye(19, **F64)[None])


@pytest.mark.parametrize("pieces", [4, 8])
def test_kkt_direction_matches_jax(pieces):
    """P=4 (ns = 33) factors with the modified Cholesky; P=8 (ns = 69 > 64)
    with the block-tridiagonal factorization."""
    ops, (jc, js, jp, _), (c, s, p, _) = _problem(pieces, 4, 2.0)
    want = jax.jit(jadmm.spline_direction, static_argnums=(1,))(jc, CFG, js, jp)
    got = admm.spline_direction(c, TCFG, s, p)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-8)


@pytest.mark.parametrize("coarse_k", [0, 64])
def test_topk_candidates_match_jax(coarse_k):
    ops, (jc, js, _, jscene), (c, s, _, scene) = _problem(4, 5)
    hull = en.seg_cps(c, s.spline)
    want = jbp.topk_candidates(jen.seg_cps(jc, js.spline), jscene, 0.8, 16, coarse_k=coarse_k)
    got = bp.topk_candidates(hull, scene, 0.8, 16, coarse_k=coarse_k)
    for g, w in zip(got, want):
        _close(g, w)
    assert bool(got.mask.any()) and not bool(got.mask.all())
    _close(bp.coarse_overflow(hull, scene, 0.8, 16),
           jbp.coarse_overflow(jen.seg_cps(jc, js.spline), jscene, 0.8, 16))


_jax_max_step = jax.jit(jccd.obstacle_max_step_direct, static_argnums=(4, 5, 6, 7, 8, 9))


def _max_steps(hull, dhull, pts, s1_slots, n_slots=8):
    args = [hull[None, None, None], dhull[None, None, None], pts]
    want = float(_jax_max_step(*map(jnp.asarray, args), jnp.ones(len(pts), bool),
                               0.1, 64, False, s1_slots, n_slots, 64)[0])
    got = float(ccd.obstacle_max_step_direct(
        *(torch.as_tensor(a, **F64) for a in args), torch.ones(len(pts), dtype=torch.bool),
        0.1, 64, s1_slots=s1_slots, n_slots=n_slots,
    )[0])
    return got, want


@pytest.mark.parametrize("s1_slots", [128, 4])
def test_obstacle_max_step_direct_matches_jax(s1_slots):
    """The direct-path cases of tests/test_ccd_sound.py::test_obstacle_direct_sound."""
    rng = np.random.default_rng(7)
    shrunk = 0
    for _ in range(12):
        hull = rng.normal(size=(6, 3))
        dhull = rng.normal(size=(6, 3)) * 2.0
        pts = rng.normal(size=(128, 3)) * 2.0
        got, want = _max_steps(hull, dhull, pts, s1_slots)
        assert got == pytest.approx(want, rel=1e-10, abs=1e-12)
        shrunk += 0.0 < want < 1.0
    # tiny slot counts legitimately cap many cases to 0
    assert shrunk > 0 or s1_slots < 128


def test_obstacle_max_step_direct_near_contact_matches_jax():
    """tests/test_ccd_sound.py::test_obstacle_direct_escapes_near_contact."""
    rng = np.random.default_rng(8)
    hull = rng.normal(size=(6, 3)) * 0.3
    probe = np.array([10.0, 0.3, -0.2])
    hd = jgeo.point_hull_distance(jnp.asarray(hull), jnp.asarray(probe), 200)
    pt = probe - np.asarray(hd.v) + np.asarray(hd.v) / float(hd.dist) * (0.1 + 0.012)
    dhull = rng.normal(size=(6, 3))
    got, want = _max_steps(hull, dhull, pt[None], 32, 32)
    assert want > 0.0
    assert got == pytest.approx(want, rel=1e-10)


def test_rung_floor_lattice():
    for s, want in [(1.5, 1.0), (1.0 + 1e-6, 1.0), (1.0, 0.8), (0.9, 0.8), (0.8, 0.8 ** 2),
                    (0.79, 0.8 ** 2), (0.0, 0.0), (-1.0, 0.0), (1e-9, 0.0)]:
        got = float(admm.rung_floor(TCFG, torch.tensor(s, **F64)))
        assert got == pytest.approx(want, abs=1e-12), s
