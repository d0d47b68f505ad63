"""The torch port's kernel modules against the JAX package, on the CPU.

On the CPU each kernel wrapper of `trajopt_tpu_torch` takes its plain torch
version, so these tests pin the plain versions to the JAX functions the
kernels replace, in float64 (tests/conftest.py enables x64): `lax.top_k`
for K1, `geometry.origin_simplex_dist` for K2, `ops/smallchol.py` for K3/K4
and their fused launch (and, in float32, the Pallas kernels themselves in
interpret mode).
The kernels themselves are compared with the plain versions on the card
(`test_kernels_match_plain_on_card`, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.ops import geometry as jgeo
from trajopt_tpu.ops import smallchol as jsc
from trajopt_tpu_torch import testing as kernel_cases
from trajopt_tpu_torch.config import TrajOptConfig
from trajopt_tpu_torch.ops import _cuda, cuda_chol, cuda_eig, cuda_gjk, cuda_topk
from trajopt_tpu_torch.ops import geometry as geo

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


def _topk_rows(seed):
    rng = np.random.default_rng(seed)
    ties = np.round(rng.random((6, 300)) * 8.0)              # many exact ties
    short = np.full((5, 40), np.inf)                          # < k finite entries
    for r in range(5):
        short[r, rng.choice(40, r + 1, replace=False)] = rng.normal(size=r + 1)
    mixed = rng.normal(size=(4, 2000)) ** 2
    mixed[rng.random(mixed.shape) < 0.3] = np.inf
    return [(ties, 40), (short, 12), (mixed, 64), (mixed[:, :64], 16)]


@pytest.mark.parametrize("seed", [0, 1])
def test_smallest_k_matches_lax_top_k(seed):
    for x, k in _topk_rows(seed):
        neg, jidx = jax.lax.top_k(-jnp.asarray(x), k)
        vals, idx = cuda_topk.smallest_k(torch.as_tensor(x, **F64), k)
        np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# the edge cases on which chip_smoke.py holds K1 and K2 to their plain
# versions on the card (bit-equal for K1, within 1e-5 x scale for K2):
# here the plain versions are pinned to the JAX functions on the same rows
_EDGE_ROWS = kernel_cases.topk_edge_rows(np.random.default_rng(kernel_cases.EDGE_SEED))
_GJK_EDGES = kernel_cases.gjk_edge_sets(np.random.default_rng(kernel_cases.EDGE_SEED + 1))


@pytest.fixture
def interpret_mode():
    """Run a Pallas kernel in its interpreter, as tests/test_pallas_gjk.py."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("name,x,k", _EDGE_ROWS, ids=[c[0] for c in _EDGE_ROWS])
def test_smallest_k_edge_rows_match_lax_top_k(name, x, k):
    """Ties across the cut, all-equal rows, signed zeros, NaN and +inf,
    k = 1 and k = n, n past the warp route, past the shared-memory cap, the
    large-k route.  `lax.top_k` orders -0.0 before +0.0 (a total order),
    where K1, its plain version and the Pallas kernel tie them by index
    (`test_smallest_k_ties_match_pallas_kernel`): the indices are compared
    with `lax.top_k` on ``x + 0.0``, which turns -0.0 into +0.0, and the
    values must be the input's own floats, bit for bit."""
    vals, idx = cuda_topk.smallest_k(torch.as_tensor(x, **F64), k)
    neg, jidx = jax.lax.top_k(-jnp.asarray(x + 0.0), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
    own = np.take_along_axis(x, idx.numpy(), axis=-1)
    np.testing.assert_array_equal(vals.numpy().view(np.int64), own.view(np.int64))


_TIE_ROWS = [c for c in _EDGE_ROWS
             if c[2] <= 64 and ("tie" in c[0] or "equal" in c[0] or "0.0" in c[0])]


@pytest.mark.parametrize("name,x,k", _TIE_ROWS, ids=[c[0] for c in _TIE_ROWS])
def test_smallest_k_ties_match_pallas_kernel(interpret_mode, name, x, k):
    """The TPU kernel (`pallas_topk._select_kernel`, interpret mode, float32)
    breaks ties by index and ties -0.0 with +0.0, as K1 does; its values are
    the row minima, so they are compared as numbers."""
    from trajopt_tpu.ops import pallas_topk

    x32 = x.astype(np.float32)
    pv, pi = pallas_topk._smallest_k_flat(jnp.asarray(x32), k)
    vals, idx = cuda_topk.smallest_k(torch.as_tensor(x32), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))


@pytest.mark.parametrize(
    "n,k,want",
    [(1, 1, "warp"), (33, 9, "warp"), (256, 32, "warp"), (33, 33, "radix"), (256, 256, "radix"),
     (257, 32, "radix"), (257, 257, "radix"), (60000, 64, "radix"), (4000, 1024, "radix"),
     (3000, 1025, "rounds")],
)
def test_smallest_k_route_by_shape(n, k, want):
    assert cuda_topk.route(n, k) == want


def test_edge_rows_reach_the_route_they_name():
    for name, x, k in _EDGE_ROWS:
        assert f"({cuda_topk.route(x.shape[-1], k)})" in name


@pytest.mark.parametrize("name,u,iters,n_brute", _GJK_EDGES, ids=[c[0] for c in _GJK_EDGES])
def test_gjk_exact_plain_edge_sets_match_jax(name, u, iters, n_brute):
    """m = 1 to 80 and duplicate vertices (exact ties in the support argmin):
    the plain version against `geometry.origin_simplex_dist` in float64;
    dist everywhere and lb where the origin is separated, to 1e-10; both
    sound against the converged value and the brute-force distance."""
    want = jax.vmap(lambda d: jgeo.origin_simplex_dist(d, iters))(jnp.asarray(u))
    got = cuda_gjk.gjk_exact(torch.as_tensor(u, **F64), iters)
    true = np.asarray(jax.vmap(lambda d: jgeo.origin_simplex_dist(d, 64).dist)(jnp.asarray(u)))
    scale = np.abs(u).max(axis=(1, 2))
    sep = true > 1e-3 * scale
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), rtol=1e-10,
                               atol=1e-10 * scale.max())
    np.testing.assert_allclose(got.lb.numpy()[sep], np.asarray(want.lb)[sep], rtol=1e-10)
    assert (got.lb.numpy() <= true + 1e-9 * scale).all()
    assert (got.dist.numpy() >= true - 1e-9 * scale).all()
    brute = kernel_cases.brute_origin_dist(u[:n_brute])
    assert (got.lb.numpy()[:n_brute] <= brute + 1e-9 * scale[:n_brute]).all()
    np.testing.assert_allclose(true[:n_brute], brute, atol=1e-9 * scale.max())


def _gjk_sets(seed):
    rng = np.random.default_rng(seed)
    rand = rng.normal(size=(24, 6, 3)) + rng.normal(size=(24, 1, 3)) * 1.5
    # collinear control points (straight segments), as tests/test_geometry.py
    a, b = rng.normal(size=(12, 1, 3)), rng.normal(size=(12, 1, 3))
    t = np.sort(rng.uniform(0, 1, (12, 6, 1)), axis=1)
    collinear = a * (1 - t) + b * t - rng.normal(size=(12, 1, 3)) * 1.5
    coplanar = rng.normal(size=(12, 6, 3))
    coplanar[..., 2] = 0.3
    dup = np.repeat(rng.normal(size=(12, 3, 3)), 2, axis=1) + rng.normal(size=(12, 1, 3)) * 2
    inside = rng.normal(size=(6, 6, 3)) * 0.2
    inside[:, :4] = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]])
    return np.concatenate([rand, collinear, coplanar, dup, inside])


@pytest.mark.parametrize("iters", [16, 32])
def test_origin_simplex_dist_matches_jax(iters):
    u = _gjk_sets(iters)
    want = jax.vmap(lambda d: jgeo.origin_simplex_dist(d, iters))(jnp.asarray(u))
    got = geo.origin_simplex_dist(torch.as_tensor(u, **F64), iters)
    # the converged exact solver is the truth (its own 64-iteration value)
    true = np.asarray(jax.vmap(lambda d: jgeo.origin_simplex_dist(d, 64).dist)(jnp.asarray(u)))
    _assert_same_hull_dist(got, want, true)
    assert (got.lb.numpy() <= true + 1e-9).all()
    assert (got.dist.numpy() >= true - 1e-9).all()


def _assert_same_hull_dist(got, want, true):
    """dist everywhere; lb and the witness where the origin is separated
    from the hull (in contact, lb is a path-dependent non-positive number
    and the witness roundoff-sized)."""
    sep = true > 1e-3
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.lb.numpy()[sep], np.asarray(want.lb)[sep], rtol=1e-10)
    np.testing.assert_allclose(got.v.numpy()[sep], np.asarray(want.v)[sep], rtol=1e-10, atol=1e-12)
    assert sep.sum() > 0.8 * len(sep)


def test_batched_origin_dist_caps_iterations():
    u = _gjk_sets(3)
    want = jgeo.batched_origin_dist(jnp.asarray(u), 24, pallas=False)
    got = geo.batched_origin_dist(torch.as_tensor(u, **F64), 24)
    true = np.asarray(jax.vmap(lambda d: jgeo.origin_simplex_dist(d, 64).dist)(jnp.asarray(u)))
    _assert_same_hull_dist(got, want, true)


def test_collinear_point_segment_exact():
    """Straight segments have collinear control points: the closed-form
    point-to-segment distance (tests/test_geometry.py::test_collinear_exact)."""
    rng = np.random.default_rng(5)
    for _ in range(4):
        a, b = rng.standard_normal(3), rng.standard_normal(3)
        t = np.sort(rng.uniform(0, 1, 6))[:, None]
        verts = a * (1 - t) + b * t
        point = rng.standard_normal(3) * 1.5
        ab = b - a
        s = np.clip((point - a) @ ab / (ab @ ab), t.min(), t.max())
        ref = np.linalg.norm(a + s * ab - point)
        hd = geo.point_hull_distance(torch.as_tensor(verts, **F64), torch.as_tensor(point, **F64), 16)
        assert abs(float(hd.dist) - ref) < 1e-9 * max(ref, 1.0)
        assert float(hd.lb) <= ref + 1e-9


def _blocks(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(5, 19, 19))
    pd = a @ a.transpose(0, 2, 1) + 19 * np.eye(19)
    sym = rng.normal(size=(5, 19, 19))
    return pd, sym + sym.transpose(0, 2, 1)


def test_mod_cholesky_and_solve_match_smallchol():
    pd, indef = _blocks(0)
    rhs = np.random.default_rng(1).normal(size=(5, 19, 2))
    for h in (pd, indef):
        jl, je = jsc.mod_cholesky(jnp.asarray(h))
        l, e = cuda_chol.mod_chol(torch.as_tensor(h, **F64))
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-10, atol=1e-12)
        for b in (rhs, rhs[..., 0]):
            jx = jsc.cho_solve(jl, jnp.asarray(b))
            x = cuda_chol.chol_solve(l, torch.as_tensor(b, **F64))
            np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(cuda_chol.mod_chol(torch.as_tensor(pd, **F64))[1].numpy(), 0.0)
    jl = jsc.cholesky(jnp.asarray(pd))
    l, e = cuda_chol.mod_chol(torch.as_tensor(pd, **F64), gmw=False)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-10, atol=1e-12)
    assert not e.any()


# the edge blocks on which chip_smoke.py holds K3, K4 and the fused kernel to
# their plain versions on the card: here the plain versions are pinned to the
# JAX package's `smallchol` on the same blocks (the batch of 4097 cut to 5:
# its point is the kernel's grid, which the CPU does not have)
_CHOL_EDGES = [(name, h[:5], kind) for name, h, kind in kernel_cases.chol_edge_blocks(
    np.random.default_rng(kernel_cases.EDGE_SEED + 4))]


@pytest.mark.parametrize("name,h,kind", _CHOL_EDGES, ids=[c[0] for c in _CHOL_EDGES])
def test_chol_edge_blocks_match_smallchol(name, h, kind):
    """m = 1 to 64 on each side of the kernels' tiers, zero, diagonal,
    negative definite and scaled blocks, through `mod_chol`, `chol_solve`
    and `factor_solve` on the CPU in float64 against `smallchol` at rtol
    1e-10, with every right-hand-side layout; ``want_l=False`` gives the
    same e (and x); ``gmw=False`` matches `smallchol.cholesky`, NaNs
    included on a block that is not positive definite."""
    ht = torch.as_tensor(h, **F64)
    # jitted: op by op, JAX would compile every step's shapes on their own
    jl, je = jax.jit(jsc.mod_cholesky)(jnp.asarray(h))
    l, e = cuda_chol.mod_chol(ht)
    tiny = 1e-12 * max(np.abs(h).max(), 1e-30)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-10, atol=tiny)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-10, atol=tiny)
    none, e_only = cuda_chol.mod_chol(ht, want_l=False)
    assert none is None
    np.testing.assert_array_equal(e_only.numpy(), e.numpy())
    if kind == "pd":
        assert not e.any()
    lp, ep = cuda_chol.mod_chol(ht, gmw=False)
    assert not ep.any()
    np.testing.assert_allclose(lp.numpy(), np.asarray(jax.jit(jsc.cholesky)(jnp.asarray(h))), rtol=1e-10,
                               atol=tiny)
    assert bool(lp.isnan().any()) == (kind != "pd")
    rhs = kernel_cases.chol_edge_rhs(np.random.default_rng(kernel_cases.EDGE_SEED + 5), h)
    # one JAX solve of all the columns (they are independent), cut up again
    cols = [b.reshape(b.shape[0], b.shape[1], -1) for b in rhs]
    jx_all = np.asarray(jax.jit(jsc.cho_solve)(jl, jnp.asarray(np.concatenate(cols, axis=-1))))
    stops = np.cumsum([c.shape[-1] for c in cols])
    for b, stop in zip(rhs, stops):
        jx = jx_all[..., stop - b[0].size // b.shape[1]:stop].reshape(b.shape)
        bt = torch.as_tensor(b, **F64)
        x = cuda_chol.chol_solve(l, bt)
        np.testing.assert_allclose(x.numpy(), jx, rtol=1e-10, atol=1e-12 * np.abs(jx).max())
        lf, ef, xf = cuda_chol.factor_solve(ht, bt)
        np.testing.assert_array_equal(lf.numpy(), l.numpy())
        np.testing.assert_array_equal(ef.numpy(), e.numpy())
        np.testing.assert_array_equal(xf.numpy(), x.numpy())
        none, ef, xf = cuda_chol.factor_solve(ht, bt, want_l=False)
        assert none is None
        np.testing.assert_array_equal(ef.numpy(), e.numpy())
        np.testing.assert_array_equal(xf.numpy(), x.numpy())


@pytest.mark.parametrize(
    "m,want",
    [(0, (1, 8)), (1, (1, 8)), (8, (1, 8)), (9, (1, 16)), (15, (1, 16)), (19, (1, 20)),
     (20, (1, 20)), (21, (1, 24)), (24, (1, 24)), (31, (1, 32)), (32, (1, 32)), (33, (2, 36)),
     (36, (2, 36)), (42, (2, 44)), (51, (2, 52)), (60, (2, 64)), (63, (2, 64)), (64, (2, 64))],
)
def test_chol_route_by_size(m, want):
    """(rows a lane, padded width) is a pure function of m; the width is
    the smallest built one that holds the block."""
    assert cuda_chol.route(m) == want
    assert want[1] >= m and want[0] == (1 if m <= 32 else 2)


@pytest.mark.parametrize("m", [65, 141, -1])
def test_chol_kernels_refuse_blocks_past_64(m):
    with pytest.raises(ValueError, match="m <= 64"):
        cuda_chol.route(m)


def test_chol_edge_blocks_reach_every_tier():
    tiers = {cuda_chol.route(h.shape[-1]) for _, h, _ in _CHOL_EDGES}
    assert tiers >= {(1, 8), (1, 16), (1, 20), (1, 24), (1, 32), (2, 36), (2, 44), (2, 64)}


@pytest.mark.parametrize("shape", [(5, 19, 19), (2, 33, 33)], ids=["5x19x19", "2x33x33"])
@pytest.mark.parametrize("kind", ["pd", "indefinite"])
def test_chol_plain_matches_pallas_kernels(interpret_mode, shape, kind):
    """The port's plain K3 and K4 against the TPU kernels themselves
    (`pallas_chol.mod_chol`, `chol_solve`; Pallas interpret mode, float32).
    Both run the same GMW recurrence in float32, so L and e agree to a few
    float32 roundings amplified by the recurrence: 2e-5 of the largest
    entry.  In the solve the TPU kernel multiplies by the reciprocal of the
    diagonal where the port divides, one more rounding a step: x is held to
    2e-5 relative on the positive-definite blocks and, on the indefinite
    ones (where the GMW-boosted factor can be ill-conditioned), to the
    residual |L L^T x - b| <= 1e-4 |b| of each solution on its own factor."""
    from trajopt_tpu.ops import pallas_chol

    rng = np.random.default_rng(sum(shape) + len(kind))
    a = rng.normal(size=shape)
    h = a @ a.transpose(0, 2, 1) + shape[-1] * np.eye(shape[-1]) if kind == "pd" \
        else a + a.transpose(0, 2, 1)
    h = h.astype(np.float32)
    rhs = rng.normal(size=shape[:2] + (2,)).astype(np.float32)
    pl_l, pl_e = pallas_chol.mod_chol(jnp.asarray(h))
    l, e = cuda_chol.mod_chol(torch.as_tensor(h))
    np.testing.assert_allclose(l.numpy(), np.asarray(pl_l), rtol=0, atol=2e-5 * np.abs(l.numpy()).max())
    np.testing.assert_allclose(e.numpy(), np.asarray(pl_e), rtol=0,
                               atol=2e-5 * max(np.abs(e.numpy()).max(), np.abs(h).max()))
    if kind == "pd":
        assert not e.any() and not np.asarray(pl_e).any()
        pl_lp, pl_ep = pallas_chol.mod_chol(jnp.asarray(h), gmw=False)
        lp, _ = cuda_chol.mod_chol(torch.as_tensor(h), gmw=False)
        np.testing.assert_allclose(lp.numpy(), np.asarray(pl_lp), rtol=0,
                                   atol=2e-5 * np.abs(lp.numpy()).max())
        assert not np.asarray(pl_ep).any()
    for b in (rhs, rhs[..., 0]):
        pl_x = np.asarray(pallas_chol.chol_solve(pl_l, jnp.asarray(b)))
        x = cuda_chol.chol_solve(l, torch.as_tensor(b)).numpy()
        assert pl_x.shape == x.shape
        if kind == "pd":
            np.testing.assert_allclose(x, pl_x, rtol=0, atol=2e-5 * np.abs(x).max())
        for sol, fac in ((x, l.numpy()), (pl_x, np.asarray(pl_l))):
            sol2, b2 = (sol, b) if b.ndim == 3 else (sol[..., None], b[..., None])
            fac = fac.astype(np.float64)
            res = fac @ (fac.transpose(0, 2, 1) @ sol2.astype(np.float64)) - b2
            assert np.linalg.norm(res) <= 1e-4 * np.linalg.norm(b2)


@pytest.mark.parametrize(
    "call",
    [
        lambda x: cuda_topk.smallest_k(x.reshape(8, 8), 3),
        lambda x: cuda_gjk.gjk_exact(x[:48].reshape(8, 2, 3), 16),
        lambda x: cuda_chol.mod_chol(x[:48].reshape(3, 4, 4)),
        lambda x: cuda_chol.chol_solve(x[:16].reshape(1, 4, 4), x[:4].reshape(1, 4)),
        lambda x: cuda_chol.factor_solve(x[:48].reshape(3, 4, 4), x[48:60].reshape(3, 4)),
        lambda x: cuda_eig.eigvalsh(x[:48].reshape(3, 4, 4)),
    ],
    ids=["smallest_k", "gjk_exact", "mod_chol", "chol_solve", "factor_solve", "eigvalsh"],
)
def test_off_cpu_tensors_never_take_the_plain_path(call):
    """A tensor that is not on the CPU goes to the kernel route, which takes
    contiguous float32 CUDA tensors only: float64 raises TypeError, another
    device ValueError; neither falls back to the plain version."""
    with pytest.raises(TypeError, match="float32"):
        call(torch.empty(64, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.empty(64, dtype=torch.float32, device="meta"))


def test_use_pallas_gjk_false_is_refused_on_cuda():
    cfg = TrajOptConfig(use_pallas_gjk=False)
    with pytest.raises(ValueError, match="use_pallas_gjk"):
        geo.check_gjk_route(cfg, torch.device("cuda"))
    geo.check_gjk_route(cfg, torch.device("cpu"))          # no effect on the CPU
    geo.check_gjk_route(TrajOptConfig(), torch.device("cuda"))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Builds the kernels and runs chip_smoke.py's kernel-against-plain phase."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python3 chip_smoke.py)")
    import chip_smoke

    errs = chip_smoke.check_kernels(torch.device("cuda"), lambda s: None)
    assert set(errs) == set(_cuda.LAUNCHES)
    with pytest.raises(TypeError, match="float32"):
        cuda_topk.smallest_k(torch.zeros(4, 8, dtype=torch.float64, device="cuda"), 2)
