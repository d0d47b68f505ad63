"""Edge-case inputs and a float64 oracle for checking K1 (`smallest_k`), K2
(`gjk_exact`), K3/K4 (`mod_chol`, `chol_solve`, `factor_solve`) and K5
(`gjk_diffset`, `gjk_pairs`) where their decisions and their routes are
most fragile.

``chip_smoke.py`` holds the kernels to their plain versions on these inputs
on the card; ``tests/test_torch_kernels.py`` pins the plain versions to the
JAX package's functions on the same inputs on the CPU.  numpy only; the
generators draw from ``rng`` alone, so a seed fixes every input.
"""

from __future__ import annotations

import itertools

import numpy as np

EDGE_SEED = 7   # the edge cases' own generators start here, so that the other
                # cases of a check keep their inputs


def topk_edge_rows(rng):
    """(name, rows, k) aimed at K1's routes (`cuda_topk.route`) and its tie
    rules, float64 numpy: ties across the k-th value, all-equal rows, -0.0
    with +0.0, NaN and +inf, k = 1 and k = n, n and k just past the warp
    route's limits, a row past the shared-memory cap, and the large-k
    route.  Each name ends with the route it reaches."""

    def cut_tie(r, n, k, span):
        """rows whose k-th value is a tie that spans the cut"""
        a = 1.0 + rng.random((r, n)) * 10.0
        for row in a:
            row[rng.choice(n, k - span // 2, replace=False)] = 0.25
            row[rng.choice(np.flatnonzero(row != 0.25), span, replace=False)] = 0.5
        return a

    def signed_zeros(r, n):
        a = np.where(rng.random((r, n)) < 0.5, 0.0, -0.0)
        some = rng.random((r, n)) < 0.3
        a[some] = rng.normal(size=int(some.sum()))
        return a

    def nan_inf(r, n, nan_frac, inf_frac):
        a = rng.random((r, n))
        u = rng.random((r, n))
        a[u < nan_frac + inf_frac] = np.inf
        a[u < nan_frac] = np.nan
        return a

    return [
        ("edge tie across the cut [4,64] k=20 (warp)", cut_tie(4, 64, 20, 12), 20),
        ("edge tie across the cut [4,3000] k=64 (radix)", cut_tie(4, 3000, 64, 40), 64),
        ("edge all equal [4,256] k=32 (warp)", np.full((4, 256), 2.0), 32),
        ("edge all equal [4,500] k=64 (radix)", np.full((4, 500), 2.0), 64),
        ("edge +-0.0 [8,40] k=20 (warp)", signed_zeros(8, 40), 20),
        ("edge +-0.0 [4,700] k=300 (radix)", signed_zeros(4, 700), 300),
        ("edge NaN and +inf [4,48] k=32 (warp)", nan_inf(4, 48, 0.3, 0.3), 32),
        ("edge NaN and +inf [4,400] k=400 (radix)", nan_inf(4, 400, 0.3, 0.3), 400),
        ("edge all NaN [2,300] k=7 (radix)", np.full((2, 300), np.nan), 7),
        ("edge all +inf [2,20] k=20 (warp)", np.full((2, 20), np.inf), 20),
        ("edge k=1 [64,64] (warp)", rng.random((64, 64)), 1),
        ("edge k=1 [16,1000] (radix)", rng.random((16, 1000)), 1),
        ("edge k=n [8,256] (radix)", rng.random((8, 256)), 256),
        ("edge k=n [1,1] (warp)", rng.random((1, 1)), 1),
        ("edge n=33 [16,33] k=9 (warp)", np.round(rng.random((16, 33)) * 4.0), 9),
        ("edge n=257 [8,257] k=257 (radix)", np.round(rng.random((8, 257)) * 4.0), 257),
        ("edge n=257 [8,257] k=32 (radix)", rng.random((8, 257)), 32),
        ("edge past the shared-memory cap [2,60000] k=64 (radix)", rng.random((2, 60000)), 64),
        ("edge large k [2,3000] k=1500 (rounds)", np.round(rng.random((2, 3000)) * 50.0), 1500),
        ("edge k=n [8,32] (warp)", np.round(rng.random((8, 32)) * 4.0), 32),
        ("edge k=33 [8,33] (radix)", np.round(rng.random((8, 33)) * 4.0), 33),
    ]


def gjk_edge_sets(rng):
    """(name, u, iters, brute rows) aimed at K2's layout, float64 numpy: m =
    1, 2, 4, 16, 17, 36, 64 and 80 (one to four vertices a lane of its
    16-lane group, and the m > 64 path that reads device memory), the origin
    inside some hulls, and duplicate vertices on different lanes, so that
    the support argmin meets exact ties.  ``brute rows``: how many leading
    problems `brute_origin_dist` checks."""
    out = []
    for n, m in ((64, 1), (64, 2), (128, 4), (128, 16), (128, 17), (128, 36), (64, 64), (64, 80)):
        centre = rng.normal(size=(n, 1, 3)) * rng.choice([0.0, 0.3, 2.0], size=(n, 1, 1))
        out.append((f"edge m={m} [{n},{m},3]", rng.normal(size=(n, m, 3)) + centre, 16,
                    8 if m <= 36 else 1))
    base = rng.normal(size=(128, 12, 3)) * 0.5 + rng.normal(size=(128, 1, 3))
    dup = np.concatenate([base, base[:, ::-1], base], axis=1)          # j, 23 - j, j + 24 alike
    out.append(("edge duplicates [128,36,3]", dup, 16, 8))
    return out


def fw_edge_sets(rng):
    """(name, x, iters, brute rows) aimed at K5's routes (`cuda_gjk.fw_route`)
    and its tie rules, float64 numpy: ``x`` is a difference set u [N, m, 3]
    or a pair of hull batches (a, b) for `gjk_pairs`.  m = 1 and 2 (groups
    of 1 and 2 lanes), 37 (not a multiple of the group), 64 (the last
    register tier), 65 and 144 (12-vertex hull pairs) in shared memory, 513
    in device memory; duplicated vertices (exact score ties), the origin
    inside the hull, a coplanar set, and hull pairs separated at 1e3 scale.
    Each name ends with the tier it reaches.  ``brute rows``: how many
    leading problems `brute_origin_dist` checks (all where m <= 12, at most
    4 where m <= 64, none above: 144 vertices have 17 M 4-subsets)."""

    def cloud(n, m, spread=1.0):
        centre = rng.normal(size=(n, 1, 3)) * rng.choice([0.3, 1.5, 3.0], size=(n, 1, 1))
        return rng.normal(size=(n, m, 3)) * spread + centre

    def hull_pairs(n, m, gap, size):
        way = rng.normal(size=(n, 1, 3))
        way *= gap / np.linalg.norm(way, axis=2, keepdims=True)
        return rng.normal(size=(n, m, 3)) * size, rng.normal(size=(n, m, 3)) * size + way

    base = rng.normal(size=(32, 12, 3)) * 0.5 + rng.normal(size=(32, 1, 3)) * 1.5
    inside = rng.normal(size=(16, 24, 3))
    inside -= inside.mean(axis=1, keepdims=True)                    # the centroid at the origin
    coplanar = rng.normal(size=(16, 30, 3))
    coplanar[..., 2] = 0.4 * rng.choice([-1.0, 1.0], size=(16, 1))
    return [
        ("edge m=1 [16,1,3] (registers)", cloud(16, 1), 24, 16),
        ("edge m=2 [16,2,3] (registers)", cloud(16, 2), 24, 16),
        ("edge m=37 [24,37,3] (registers)", cloud(24, 37), 32, 4),
        ("edge m=64 [16,64,3] (registers)", cloud(16, 64), 32, 2),
        ("edge m=65 [12,65,3] (shared)", cloud(12, 65), 32, 0),
        ("edge m=144 pairs [8,12]x[8,12] (shared)", hull_pairs(8, 12, 2.5, 0.3), 32, 0),
        ("edge m=513 [3,513,3] (device)", cloud(3, 513), 32, 0),
        ("edge duplicates [32,36,3] (registers)",
         np.concatenate([base, base[:, ::-1], base], axis=1), 32, 4),   # j, 23 - j, j + 24 alike
        ("edge origin inside [16,24,3] (registers)", inside, 32, 4),
        ("edge coplanar [16,30,3] (registers)", coplanar, 32, 4),
        ("edge separated at 1e3 pairs [16,6]x[16,6] (registers)", hull_pairs(16, 6, 3000.0, 300.0),
         32, 16),
    ]


CHOL_EDGE_SIZES = (1, 2, 15, 24, 31, 32, 33, 42, 60, 63, 64)


def chol_edge_blocks(rng):
    """(name, h, kind) aimed at the routes of K3/K4 (`cuda_chol.route`),
    float64 numpy, h [batch, m, m] symmetric: every size of
    `CHOL_EDGE_SIZES` (each side of the one-row and two-row tiers and of
    their padded widths) positive definite and indefinite, then 19 x 19
    blocks that are zero, diagonal (mixed signs), negative definite, scaled
    by 1e6 and by 1e-6, and batches of 1 and of 4097.  ``kind`` is "pd"
    (GMW must not boost; a plain Cholesky exists) or "other"."""

    def pd(b, m):
        a = rng.normal(size=(b, m, m))
        return a @ a.transpose(0, 2, 1) + m * np.eye(m)

    def sym(b, m):
        a = rng.normal(size=(b, m, m))
        return a + a.transpose(0, 2, 1)

    out = []
    for m in CHOL_EDGE_SIZES:
        out.append((f"edge PD [3,{m},{m}]", pd(3, m), "pd"))
        out.append((f"edge indefinite [3,{m},{m}]", sym(3, m), "other"))
    diag = np.zeros((2, 19, 19))
    diag[:, np.arange(19), np.arange(19)] = rng.normal(size=(2, 19)) * 3.0
    out += [
        ("edge zero [2,19,19]", np.zeros((2, 19, 19)), "other"),
        ("edge diagonal [2,19,19]", diag, "other"),
        ("edge negative definite [2,19,19]", -pd(2, 19), "other"),
        ("edge PD x 1e6 [2,19,19]", pd(2, 19) * 1e6, "pd"),
        ("edge PD x 1e-6 [2,19,19]", pd(2, 19) * 1e-6, "pd"),
        ("edge batch of 1 [1,19,19]", pd(1, 19), "pd"),
        ("edge batch of 4097 [4097,19,19]", pd(4097, 19), "pd"),
    ]
    return out


def chol_edge_rhs(rng, h):
    """Right-hand sides for blocks h [batch, m, m] in the four layouts the
    solve takes: [batch, m], [batch, m, 1], [batch, m, 2], [batch, m, 5]."""
    b, m = h.shape[0], h.shape[-1]
    return [rng.normal(size=shape) for shape in ((b, m), (b, m, 1), (b, m, 2), (b, m, 5))]


def brute_origin_dist(u):
    """Exact float64 distance from the origin to conv(u[i]) (u [N,m,3]):
    the minimum over every affinely independent vertex subset of size <= 3
    whose affine projection of the origin has non-negative barycentrics,
    and 0 when a 4-subset contains the origin."""
    u = np.asarray(u, dtype=np.float64)
    n, m, _ = u.shape
    best = np.full(n, np.inf)
    subsets = {k: np.array(list(itertools.combinations(range(m), k))) for k in (1, 2, 3, 4)}
    for i in range(n):
        for k in (1, 2, 3):
            if k > m:
                continue
            w = u[i][subsets[k]]                                 # [C,k,3]
            c = len(w)
            a = np.zeros((c, k + 1, k + 1))
            a[:, :k, :k] = np.einsum("cid,cjd->cij", w, w)
            a[:, :k, k] = 1.0
            a[:, k, :k] = 1.0
            rhs = np.zeros((c, k + 1))
            rhs[:, k] = 1.0
            lam = np.einsum("cij,cj->ci", np.linalg.pinv(a), rhs)[:, :k]
            ok = (lam >= -1e-12).all(1) & (np.abs(lam.sum(1) - 1.0) < 1e-9)
            d = np.linalg.norm(np.einsum("ci,cid->cd", lam, w), axis=1)
            if ok.any():
                best[i] = min(best[i], d[ok].min())
        if m >= 4:
            w = u[i][subsets[4]]
            a = np.concatenate([w.transpose(0, 2, 1), np.ones((len(w), 1, 4))], axis=1)
            rhs = np.array([0.0, 0.0, 0.0, 1.0])
            sol = np.einsum("cij,j->ci", np.linalg.pinv(a), rhs)
            res = np.abs(np.einsum("cij,cj->ci", a, sol) - rhs).max(1)
            if ((sol >= -1e-12).all(1) & (res < 1e-9)).any():
                best[i] = 0.0
    return best
