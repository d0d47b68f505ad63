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


def _psd_blocks(kind, seed=7):
    """[6,19,19] symmetric blocks: indefinite, positive definite, or with
    a NaN or an inf entry in some blocks (the Gershgorin fallback)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(6, 19, 19))
    h = 0.5 * (a + a.transpose(0, 2, 1))
    if kind == "pd":
        h = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(19)
    elif kind == "nonfinite":
        h[1, 3, 3] = np.nan
        h[2, 4, 7] = h[2, 7, 4] = np.inf
        h[4, 0, 5] = h[4, 5, 0] = np.nan
    return h


@pytest.mark.parametrize("kind", ["indefinite", "pd", "nonfinite"])
def test_psd_repair_matches_jax(kind):
    """The eigenvalue shift of ``psd_method="eigh"`` against JAX's, rtol
    1e-10 (NaN where JAX has NaN)."""
    h = _psd_blocks(kind)
    want = np.asarray(jgr.psd_repair(jnp.asarray(h)))
    got = gr.psd_repair(torch.tensor(h))
    scale = float(np.abs(want[np.isfinite(want)]).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * scale)
    assert gr.apply_psd_repair(TCFG.replace(psd_method="eigh"), torch.tensor(h)).shape == h.shape
    if kind == "indefinite":
        assert float(torch.linalg.eigvalsh(got).min()) > 0.0099
    if kind == "pd":
        np.testing.assert_array_equal(got.numpy(), h)


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


@pytest.mark.slow
@pytest.mark.parametrize("path", ["two_level", "fleet"])
def test_broad_phase_ids_exact_above_2_to_24(path):
    """The port gathers the coarse slots' cloud ids as integers
    (`broadphase.topk_candidates`, `fleet_candidates`), where the reference
    maps them through a one-hot contraction in the spline dtype, exact in
    float32 only below 2^24 points.  A float32 cloud of 2^24 + 4096 points,
    the far ones first and the in-radius ones at ids above 2^24: every
    returned id is the brute-force one, odd ids included.  Slow: the cloud
    alone is 200 MB and each row of the coarse selection 2^24 long."""
    n_far, n_near = 2 ** 24, 4096
    rng = np.random.default_rng(24)
    near = rng.uniform(-0.6, 0.6, size=(n_near, 3))
    cloud = np.concatenate([np.full((n_far, 3), 1e3) + rng.uniform(0, 1, size=(n_far, 3)),
                            near]).astype(np.float32)
    scene = tt.make_scene(cloud, device="cpu", dtype=torch.float32)
    hull = torch.as_tensor(rng.uniform(-0.2, 0.2, size=(1, 2, 2, 6, 3)), dtype=torch.float32)
    radius, k = 0.3, 16
    if path == "two_level":
        cand = bp.topk_candidates(hull, scene, radius, k, coarse_k=64)
    else:
        cand, _ = bp.fleet_candidates(hull, scene, radius, k, coarse_k=64, piece_budget=2)
    lo, hi = bp.hull_aabbs(hull)
    d2 = bp.aabb_point_dist2(lo.double(), hi.double(),
                             torch.as_tensor(cloud[n_far:], dtype=torch.float64))  # [1,P,R,n_near]
    want = torch.sort(d2, dim=-1, stable=True).indices[..., :k] + n_far
    live = cand.mask
    assert bool(live.any())
    assert torch.equal(cand.idx[live], want[live])
    assert bool((cand.idx[live] > n_far).all()) and bool((cand.idx[live] % 2 == 1).any())


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


@pytest.mark.parametrize("t", [0.3, 30.0], ids=["t0.3", "t30"])
@pytest.mark.parametrize("piece", [0, 1, 3], ids=["first", "middle", "last"])
@pytest.mark.parametrize("seed", [0, 1])
def test_slack_closed_form_matches_torch_func(seed, piece, t):
    """The closed-form gradient and Hessian of the slack energy that the
    card's slack kernel (`ops/cuda_slack.py`, ``csrc/slack.cu``) computes,
    written out here, against `gradients.grad_and_hess` (`torch.func`) of
    `gradients.local_slack_energy` in float64 at rtol 1e-10, both after the
    freeze mask of piece ``piece`` of 4.  With a(t) = ks/2 t^-n (n = 2 der -
    1) and q = sum_d p_d^T M p_d:
    g_p = 2a M p - mu (c - p) - lambda, g_t = a' q + 1.1 kt t^0.1 - mu (T -
    t) - lambda_t, H_pp = (2a M + mu I) x I_3, H_pt = 2a' M p, H_tt = a'' q +
    0.11 kt t^-0.9 + mu."""
    from trajopt_tpu_torch.ops import splines as tsp

    rng = np.random.default_rng(seed)
    cfg = tconfig.TrajOptConfig(ks=1e-3)
    m = tt.device_consts(tsp.build_spline_ops(4, 2), **F64).m_dyn
    p, c, lam = (torch.as_tensor(rng.normal(size=(6, 3)), **F64) for _ in range(3))
    big_t, t_lam = (torch.tensor(v, **F64) for v in (rng.uniform(1.0, 5.0), rng.normal()))
    x = torch.cat([p.reshape(-1), torch.tensor([t], **F64)])
    g_ref, h_ref = gr.grad_and_hess(
        lambda x: gr.local_slack_energy(x, c, big_t, lam, t_lam, m, cfg), x)

    n = 2 * cfg.der - 1
    a = cfg.ks / 2 * t ** -n
    a1, a2 = -n * a / t, n * (n + 1) * a / t ** 2
    mp = m @ p
    q = torch.sum(p * mp)
    g = torch.cat([(2 * a * mp - cfg.mu * (c - p) - lam).reshape(-1),
                   (a1 * q + 1.1 * cfg.kt * t ** 0.1 - cfg.mu * (big_t - t) - t_lam)[None]])
    h = torch.zeros((19, 19), **F64)
    h[:18, :18] = torch.kron(2 * a * m + cfg.mu * torch.eye(6, **F64), torch.eye(3, **F64))
    h[:18, 18] = h[18, :18] = 2 * a1 * mp.reshape(-1)
    h[18, 18] = a2 * q + 0.11 * cfg.kt * t ** -0.9 + cfg.mu

    mask = admm._slack_freeze_mask(4, torch.float64, "cpu")[piece]
    keep = (mask[:, None] * mask[None, :]) > 0
    eye = torch.eye(19, **F64)
    _close(g * mask, g_ref * mask)
    _close(torch.where(keep, h, eye), torch.where(keep, h_ref, eye))


# ---------------------------------------------------------------------------
# the direction phase's kernel chain (ops/cuda_direction.py): its plain
# versions and the dispatch
# ---------------------------------------------------------------------------


def _direction_case(name, dtype):
    from trajopt_tpu_torch import testing

    _, pieces, edge = next(c for c in testing.DIRECTION_CASES if c[0] == name)
    consts, cfg, state, planes = testing.direction_case(pieces, edge)
    cast = lambda x: type(x)(*(t.to(dtype) if t.is_floating_point() else t for t in x))
    return cast(consts), cfg, cast(state), cast(planes)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["bridge", "planes", "gmw", "vel", "fallback", "p7"])
def test_direction_slices_compose_to_the_plain_path(name, dtype):
    """On the CPU the chain of the four kernels' plain versions with K3's,
    K3+K4's and K4's (`admm.spline_direction_kernels`) is
    `admm.spline_direction_plain` bit for bit, NaN in the same places, on
    every case of `testing.DIRECTION_CASES`, in float64 and float32."""
    consts, cfg, state, planes = _direction_case(name, dtype)
    got = admm.spline_direction_kernels(consts, cfg, state, planes)
    want = admm.spline_direction_plain(consts, cfg, state, planes)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype == dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_spline_direction_takes_the_plain_path_off_the_kernels_conditions(monkeypatch):
    """`cuda_direction.engages` (what `admm.spline_direction` dispatches on)
    holds for a single UAV's float32 spline on the card under "gmw" with
    the closed-form Hessian at P <= 7, and for nothing else: not the CPU,
    float64, a fleet's spline, ``eigh``, ``ladder``, ``autodiff`` or P = 8.
    On the CPU `spline_direction` runs `spline_direction_plain` and
    launches none of the four kernels; forced to engage there, it runs the
    chain (`spline_direction_kernels`) to the same bits."""
    import types

    from trajopt_tpu_torch.ops import _cuda
    from trajopt_tpu_torch.ops import cuda_direction as cd
    from trajopt_tpu_torch.ops import splines as tsp

    consts, cfg, state, planes = _direction_case("planes", torch.float64)
    consts8 = tt.device_consts(tsp.build_spline_ops(8, cfg.res), **F64)
    card = lambda dtype=torch.float32, ndim=2: types.SimpleNamespace(
        device=torch.device("cuda"), dtype=dtype, ndim=ndim)
    assert cd.engages(consts, cfg, card())
    assert cd.engages(tt.device_consts(tsp.build_spline_ops(7, cfg.res), **F64), cfg, card())
    assert not cd.engages(consts, cfg, state.spline.float())
    assert not cd.engages(consts, cfg, card(torch.float64))
    assert not cd.engages(consts, cfg, card(ndim=3))
    for options in (dict(psd_method="eigh"), dict(psd_method="ladder"), dict(grad_mode="autodiff")):
        assert not cd.engages(consts, cfg.replace(**options), card())
    assert not cd.engages(consts8, cfg, card())

    calls = []
    for name in ("spline_direction_plain", "spline_direction_kernels"):
        real = getattr(admm, name)
        monkeypatch.setattr(admm, name, lambda *a, real=real, name=name: calls.append(name)
                            or real(*a))
    before = dict(_cuda.LAUNCHES)
    for options in ({}, dict(psd_method="eigh"), dict(psd_method="ladder"),
                    dict(grad_mode="autodiff")):
        admm.spline_direction(consts, cfg.replace(**options), state, planes)
    assert calls == ["spline_direction_plain"] * 4
    assert {k: _cuda.LAUNCHES[k] for k in cd.KERNELS} == {k: before[k] for k in cd.KERNELS}
    want = admm.spline_direction(consts, cfg, state, planes)
    monkeypatch.setattr(cd, "engages", lambda *a: True)
    calls.clear()
    got = admm.spline_direction(consts, cfg, state, planes)
    assert calls == ["spline_direction_kernels"]
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
