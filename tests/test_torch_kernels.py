"""The torch port's kernel modules against the JAX package, on the CPU.

On the CPU each kernel wrapper of `trajopt_tpu_torch` takes its plain torch
version, so these tests pin the plain versions to the JAX functions the
kernels replace, in float64 (tests/conftest.py enables x64): `lax.top_k`
for K1, `geometry.origin_simplex_dist` for K2, `ops/smallchol.py` for K3/K4.
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
from trajopt_tpu_torch.ops import _cuda, cuda_chol, cuda_gjk, cuda_topk
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


@pytest.mark.parametrize(
    "call",
    [
        lambda x: cuda_topk.smallest_k(x.reshape(8, 8), 3),
        lambda x: cuda_gjk.gjk_exact(x[:48].reshape(8, 2, 3), 16),
        lambda x: cuda_chol.mod_chol(x[:48].reshape(3, 4, 4)),
        lambda x: cuda_chol.chol_solve(x[:16].reshape(1, 4, 4), x[:4].reshape(1, 4)),
    ],
    ids=["smallest_k", "gjk_exact", "mod_chol", "chol_solve"],
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
