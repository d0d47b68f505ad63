"""Edge-case inputs and a float64 oracle for checking K1 (`smallest_k`), K2
(`gjk_exact`), K3/K4 (`mod_chol`, `chol_solve`, `factor_solve`), K5
(`gjk_diffset`, `gjk_pairs`), K6 (`eigvalsh`), `slack_step`
(`slack_cases`) and the direction phase's kernels (`direction_case`)
where their decisions and their routes are most fragile, and a float32
model of K6's algorithm (`eig_kernel_model`).

``chip_smoke.py`` holds the kernels to their plain versions on these inputs
on the card; ``tests/test_torch_kernels.py`` pins the plain versions to the
JAX package's functions on the same inputs on the CPU.  The generators are
numpy and draw from ``rng`` alone, so a seed fixes every input.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

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


EIG_EDGE_SIZES = (1, 2, 18, 19, 20, 32)


def eig_edge_blocks(rng):
    """(name, h) for K6 (`cuda_eig.eigvalsh`), float64 numpy, h [batch, m, m]
    symmetric: random blocks at every size of `EIG_EDGE_SIZES` (one and two
    rows, odd and even orders around the solver's 19, a full warp), then
    19 x 19 blocks that are diagonal, positive definite, negative definite,
    the identity and rank one plus the identity (eigenvalues repeated 18
    times), random ones scaled by 1e-6 and by 1e6, one with a NaN and one
    with an inf entry beside a finite block, and batches of 1 and of 4097."""

    def sym(b, m, scale=1.0):
        a = rng.normal(size=(b, m, m))
        return (a + a.transpose(0, 2, 1)) * scale

    def pd(b, m):
        a = rng.normal(size=(b, m, m))
        return a @ a.transpose(0, 2, 1) + 0.1 * np.eye(m)

    out = [(f"edge random [8,{m},{m}]", sym(8, m)) for m in EIG_EDGE_SIZES]
    diag = np.zeros((8, 19, 19))
    diag[:, np.arange(19), np.arange(19)] = rng.normal(size=(8, 19)) * 3.0
    v = rng.normal(size=(8, 19))
    nonfinite = sym(3, 19)
    nonfinite[1, 4, 7] = nonfinite[1, 7, 4] = np.nan
    nonfinite[2, 0, 0] = np.inf
    out += [
        ("edge diagonal [8,19,19]", diag),
        ("edge positive definite [8,19,19]", pd(8, 19)),
        ("edge negative definite [8,19,19]", -pd(8, 19)),
        ("edge identity [4,19,19]", np.broadcast_to(np.eye(19), (4, 19, 19)).copy()),
        ("edge rank one plus identity [8,19,19]", np.einsum("bi,bj->bij", v, v) + np.eye(19)),
        ("edge x 1e-6 [8,19,19]", sym(8, 19, 1e-6)),
        ("edge x 1e6 [8,19,19]", sym(8, 19, 1e6)),
        ("edge NaN and inf [3,19,19]", nonfinite),
        ("edge batch of 1 [1,19,19]", sym(1, 19)),
        ("edge batch of 4097 [4097,19,19]", sym(4097, 19)),
    ]
    return out


EIG_MAX_SWEEPS = 15           # csrc/eig.cu's kMaxSweeps
EIG_TINY = 2.0 ** -60         # an |a_pq| at or below this (scaled block) is set to 0 unrotated
_EPS32 = 2.0 ** -23


def eig_padded(m: int) -> int:
    """The order K6 pads an m x m block to: even, and >= 6 past m = 2."""
    return 2 if m <= 2 else max(6, m + (m & 1))


def eig_sweep_pairs(n: int) -> list[list[tuple[int, int]]]:
    """The n - 1 rounds of a sweep of K6 on n (even) indices, each the n / 2
    pairs (top, bottom) in pair order: the ring order of Brent and Luk
    (``next_slot`` in csrc/eig.cu), index 0 fixed in slot 0, every index
    back in its slot after the sweep."""
    h = n // 2

    def next_slot(s):
        if h == 1 or s == 0:
            return s
        if s % 2 == 0:
            return s + 2 if s // 2 < h - 1 else s + 1
        return s - 2 if s // 2 > 0 else 2

    slot, rounds = list(range(n)), []       # slot -> the index there
    for _ in range(n - 1):
        rounds.append([(slot[2 * k], slot[2 * k + 1]) for k in range(h)])
        moved = [0] * n
        for s in range(n):
            moved[next_slot(s)] = slot[s]
        slot = moved
    return rounds


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _fma(a, b, c):
    """a * b + c rounded once to float32: the float32 product is exact in
    float64, so only the sum rounds twice, which moves a result in far
    fewer than one case in a million."""
    return _f32(a.double() * b.double() + c.double())


def eig_rotation(app, aqq, apq):
    """(c, s, new a_pp, new a_qq) of K6's rotation zeroing a_pq (csrc/eig.cu
    ``rotation``), elementwise in float32: d = a_qq - a_pp, e = 2 a_pq,
    t = sign(d) e / (|d| + sqrt(d^2 + e^2)), c = 1 / sqrt(1 + t^2), s = t c,
    the closed forms a_pp - t a_pq and a_qq + t a_pq; identity at
    |a_pq| <= EIG_TINY.  Division and square roots are taken in float64 and
    rounded once, the correctly rounded float32 result the card gives
    (torch's own float32 square root on the CPU can miss it by one unit in
    the last place); 1 / sqrt rounds twice that way, which moves a result
    in far fewer than one case in a million."""
    d = aqq - app
    e = 2.0 * apq
    h = _f32(torch.sqrt(_fma(d, d, e * e).double()))
    t = _f32(torch.where(d >= 0, e, -e).double() / (d.abs() + h).double())
    c = _f32(1.0 / torch.sqrt(_fma(t, t, torch.ones_like(t)).double()))
    tiny = apq.abs() <= EIG_TINY
    return (torch.where(tiny, 1.0, c), torch.where(tiny, 0.0, t * c),
            torch.where(tiny, app, _fma(-t, apq, app)), torch.where(tiny, aqq, _fma(t, apq, aqq)))


def eig_kernel_model(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's algorithm (``csrc/eig.cu``) in float32 torch, round by round, on
    blocks h [..., m, m] (the lower triangle is read), on h's device:
    the power-of-two scaling, the padding (`eig_padded`), the rounds in
    K6's order (`eig_sweep_pairs`), each round's rotations formed from the
    last round's result (`eig_rotation`), rows by rotation k then columns by
    rotation l for each pair-block k < l with K6's multiply-adds (the
    blocks k > l their mirror), the closed-form diagonal and a zero a_pq,
    the stop at off^2 <= eps^2 |A|_F^2 before the first sweep and after
    each (at most `EIG_MAX_SWEEPS`), the stable sort, NaN throughout for a
    block with a non-finite entry.  Only the sums behind the stop are
    taken in another order than K6's.  Nothing in the port calls it: the
    tests hold it to float64, and chip_smoke.py counts K6's rounds with it.
    Returns (w [..., m] ascending, sweeps [...]); a block runs
    sweeps * (eig_padded(m) - 1) rounds."""
    lead, m = h.shape[:-2], h.shape[-1]
    a = _f32(h.reshape(-1, m, m))
    b, n, dev = a.shape[0], eig_padded(m), a.device
    finite = torch.isfinite(a).all(-1).all(-1)
    a = torch.where(finite[:, None, None], a, 0.0)
    A = torch.zeros(b, n, n, dtype=torch.float32, device=dev)
    A[:, :m, :m] = torch.tril(a) + torch.tril(a, -1).transpose(-1, -2)
    amax = A.abs().amax((-1, -2))
    expo = torch.where(amax > 0, torch.frexp(amax).exponent, 0).clamp(-100, 100)
    A = A * torch.ldexp(torch.ones_like(amax), -expo)[:, None, None]
    iu = torch.triu_indices(n, n, 1, device=dev)

    def off2(mat):
        u = mat[:, iu[0], iu[1]]
        return 2.0 * (u * u).sum(-1)

    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    tol2 = _EPS32 * _EPS32 * ((diag * diag).sum(-1) + off2(A))
    active = finite & (off2(A) > tol2)
    sweeps = torch.zeros(b, dtype=torch.int64, device=dev)
    k = torch.arange(n // 2, device=dev)
    upper = k[:, None] < k[None, :]
    rounds = [torch.tensor(pairs, device=dev).T for pairs in eig_sweep_pairs(n)]
    for _ in range(EIG_MAX_SWEEPS):
        if not bool(active.any()):
            break
        sweeps += active.long()
        for p, q in rounds:
            c, s, dp, dq = eig_rotation(A[:, p, p], A[:, q, q], A[:, p, q])
            pp, pq = (p[:, None], p[None, :]), (p[:, None], q[None, :])
            qp, qq = (q[:, None], p[None, :]), (q[:, None], q[None, :])
            x00, x01, x10, x11 = A[:, pp[0], pp[1]], A[:, pq[0], pq[1]], A[:, qp[0], qp[1]], \
                A[:, qq[0], qq[1]]
            ck, sk, cl, sl = c[:, :, None], s[:, :, None], c[:, None, :], s[:, None, :]
            y00, y01 = _fma(ck, x00, -sk * x10), _fma(ck, x01, -sk * x11)
            y10, y11 = _fma(sk, x00, ck * x10), _fma(sk, x01, ck * x11)
            z00, z01 = _fma(cl, y00, -sl * y01), _fma(sl, y00, cl * y01)
            z10, z11 = _fma(cl, y10, -sl * y11), _fma(sl, y10, cl * y11)
            t = lambda z: z.transpose(-1, -2)
            new = torch.empty_like(A)
            new[:, pp[0], pp[1]] = torch.where(upper, z00, t(z00))
            new[:, pq[0], pq[1]] = torch.where(upper, z01, t(z10))
            new[:, qp[0], qp[1]] = torch.where(upper, z10, t(z01))
            new[:, qq[0], qq[1]] = torch.where(upper, z11, t(z11))
            new[:, p, p], new[:, q, q] = dp, dq
            new[:, p, q] = new[:, q, p] = 0.0
            A = torch.where(active[:, None, None], new, A)
        active = active & (off2(A) > tol2)
    w = torch.sort(torch.diagonal(A, dim1=-2, dim2=-1)[:, :m], dim=-1, stable=True).values
    w = torch.where(finite[:, None], torch.ldexp(w, _f32(expo[:, None])), float("nan"))
    return w.reshape(*lead, m), sweeps.reshape(lead)


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


# The JAX package's CPU float64 solves with ``optimal_plane=True`` that
# chip_smoke.py holds the card's to (iterations within its ITER_SLACK, ccd
# within 2%): the bridge (20000 points, seed 0, P = 4; TrajOptConfig(ks=1e-8,
# max_planes=16, max_ccd_candidates=16)) and the 64-robot cross coupled
# (4000 points, seed 0, lane-assigned waypoints, P = 4; TrajOptConfig(res=8,
# ks=1e-3, max_planes=16, max_self_planes=4, max_ccd_candidates=16)).  The
# command that made them, and that checks them (~3 min on the CPU):
#     python -m pytest tests/test_torch_optimal_plane.py -m slow -k jax_rows
OPTIMAL_PLANE_JAX_ROWS = {
    "single p4": dict(iters=26, converged=True, ccd_time=9.426650342105038,
                      ccd_len=16.001589760663016, min_clearance=0.8060133208084507),
    "u64 coupled": dict(iters=22, converged=True, ccd_time=924.6096998077479,
                        ccd_len=1610.7727116115466, min_clearance=0.1422943607472134),
}


# The JAX package's CPU float64 solves with ``psd_method="ladder"`` that
# chip_smoke.py holds the card's to (phase 8: iterations within its
# ITER_SLACK, ccd within 2%), in the configurations of
# OPTIMAL_PLANE_JAX_ROWS with ``optimal_plane=False``.  The command that
# made them, and that checks them (~3 min on the CPU):
#     python -m pytest tests/test_torch_psd.py -m slow -k jax_rows
PSD_JAX_ROWS = {
    "single p4 ladder": dict(iters=26, converged=True, ccd_time=9.426693056739843,
                             ccd_len=16.001670007462607, min_clearance=0.8059663502201705),
    "u64 coupled ladder": dict(iters=22, converged=True, ccd_time=924.5679653000124,
                               ccd_len=1610.7224059124585, min_clearance=0.14277637998433032),
}


# `slack_step` against `solver.admm.slack_update_plain`: (name, robots,
# pieces, ks, edge).  Every case has the freeze mask (the first and the last
# piece of each robot); 20 pieces are more than the kernel's warps a block.
# Edges, each at one piece: "nan" (t_lambda NaN: a non-finite Newton
# direction, the steepest-descent fallback, every trial NaN and the floor
# rung), "overflow" (one lambda of 1e38: in float32 the Newton direction
# overflows, the fallback's slope is +inf and the piece takes the floor
# rung with finite control points; float64 does not overflow), "clamp"
# (t_slack 0.1 and t_lambda -50: the Newton step would take t below 0, and
# the step clamp holds it; the piece takes rung 4).
SLACK_CASES = (
    ("1x4", 1, 4, 1e-8, None),
    ("64x4", 64, 4, 1e-3, None),
    ("1024x4", 1024, 4, 1e-8, None),
    ("1x16", 1, 16, 1e-3, None),
    ("2x20", 2, 20, 1e-3, None),
    ("3x1", 3, 1, 1e-3, None),
    ("4x4 nan", 4, 4, 1e-3, "nan"),
    ("4x4 overflow", 4, 4, 1e-8, "overflow"),
    ("4x4 clamp", 4, 4, 1e-8, "clamp"),
)
SLACK_EDGE_AT = (1, 2)   # (robot, piece) of the edge
SLACK_F32_ONLY = ("overflow",)


def slack_case(robots: int, pieces: int, ks: float, edge: str | None, seed: int = 0):
    """(consts, cfg, state) for `slack_update` in float64 on the CPU: a
    fleet of ``robots`` (one robot: no leading axis) of ``pieces`` pieces,
    its spline, slacks and duals drawn from ``seed`` a few hundredths to a
    few tenths from the consensus, piece times 1.5-6, and ``edge`` at
    `SLACK_EDGE_AT` (`SLACK_CASES`)."""
    from .config import TrajOptConfig
    from .ops import splines as sp
    from .types import SolverState, device_consts

    rng = np.random.default_rng(seed)
    ops = sp.build_spline_ops(pieces, 2)
    cfg = TrajOptConfig(res=2, ks=ks)
    u, n = robots, ops.order + 1
    rows = ops.trajectory_num
    base = np.stack([np.linspace(-3, 3, rows), 0.3 * np.sin(np.linspace(0, 3, rows)),
                     np.zeros(rows)], axis=1)
    spline = base[None] + rng.normal(scale=0.03, size=(u, rows, 3))
    idx = sp.piece_row_index(pieces, ops.order)
    c = np.einsum("pij,upjd->upid", ops.convert, spline[:, idx])
    piece_time = rng.uniform(1.5, 6.0, size=u)
    p_slack = c + rng.normal(scale=0.05, size=c.shape)
    t_slack = piece_time[:, None] + rng.normal(scale=0.3, size=(u, pieces))
    p_lambda = rng.normal(scale=0.3, size=c.shape)
    t_lambda = rng.normal(scale=0.3, size=(u, pieces))
    r, q = min(SLACK_EDGE_AT[0], u - 1), min(SLACK_EDGE_AT[1], pieces - 1)
    if edge == "nan":
        t_lambda[r, q] = np.nan
    elif edge == "overflow":
        p_lambda[r, q, 2, 1] = 1e38
    elif edge == "clamp":
        t_slack[r, q], t_lambda[r, q] = 0.1, -50.0
    elif edge is not None:
        raise ValueError(f"unknown slack edge {edge!r}")
    leaves = [spline, piece_time, p_slack, t_slack, p_lambda, t_lambda]
    if u == 1:
        leaves = [x[0] for x in leaves]
    kw = dict(device="cpu", dtype=torch.float64)
    state = SolverState(*(torch.as_tensor(x, **kw) for x in leaves))
    return device_consts(ops, **kw), cfg, state


def slack_with_rungs(update, consts, cfg, state):
    """``update(consts, cfg, state)`` (`solver.admm.slack_update_plain`, or
    a copy of it in another module) with each piece's accepted rung, the
    index its ladder's ``_first_true`` (looked up on ``update``'s module)
    returns: (state, residual, rungs shaped as ``state.t_slack``)."""
    import sys

    module = sys.modules[update.__module__]
    real, got = module._first_true, []

    def spy(ok, dim=0):
        got.append(real(ok, dim))
        return got[-1]

    module._first_true = spy
    try:
        new, res = update(consts, cfg, state)
    finally:
        module._first_true = real
    return new, res, got[-1].reshape(state.t_slack.shape)


# The direction phase's kernel chain (`solver.admm.spline_direction_kernels`)
# against `solver.admm.spline_direction_plain`: (name, pieces, edge), one UAV
# at the bridge cell's res 8 and 16 planes.  Edges: "dead" (every plane slot
# masked, as on the bridge), "planes" (half the slots live, some in the
# barrier band), "gmw" (live planes 1e-5 to 1e-3 from contact: each piece's
# GMW repair boosts), "vel" and "acc" (the piece time set so that the
# largest velocity, or acceleration, bound term lies in its barrier band,
# planes live), "nan" (one t_lambda NaN: the Newton step is NaN and the
# steepest-descent fallback is taken).  P = 7 is the largest reduced
# system the chain takes (ns = 60).
DIRECTION_CASES = (
    ("bridge", 4, "dead"),
    ("planes", 4, "planes"),
    ("gmw", 4, "gmw"),
    ("vel", 4, "vel"),
    ("fallback", 4, "nan"),
    ("p7", 7, "acc"),
)
DIRECTION_EDGE_PIECE = 1   # the piece of the "nan" edge


def direction_case(pieces: int, edge: str, seed: int = 0):
    """(consts, cfg, state, planes) for `spline_direction` in float64 on the
    CPU: one UAV of ``pieces`` pieces on a gently curved line, its spline,
    slacks and duals perturbed from ``seed``, and a random plane table
    shaped by ``edge`` (`DIRECTION_CASES`)."""
    from .config import TrajOptConfig
    from .ops import energies as en
    from .ops import splines as sp
    from .types import Planes, device_consts, init_state

    if edge not in ("dead", "planes", "gmw", "vel", "acc", "nan"):
        raise ValueError(f"unknown direction edge {edge!r}")
    rng = np.random.default_rng(seed)
    cfg = TrajOptConfig(res=8, max_planes=16)
    ops = sp.build_spline_ops(pieces, cfg.res)
    u = np.linspace(0.0, 1.0, pieces + 1)
    wp = np.stack([8.0 * u - 4.0, 1.5 + 0.3 * np.sin(3.0 * u), 0.2 * np.cos(2.0 * u)], axis=1)
    kw = dict(device="cpu", dtype=torch.float64)
    state = init_state(ops, wp, cfg.init_piece_time, **kw)
    consts = device_consts(ops, **kw)
    spline = state.spline.clone()
    spline[2:-2] += torch.as_tensor(rng.normal(scale=0.05, size=spline[2:-2].shape), **kw)
    noise = lambda scale, like: torch.as_tensor(rng.normal(scale=scale, size=like.shape), **kw)
    state = state._replace(spline=spline, p_slack=state.p_slack + noise(0.05, state.p_slack),
                           t_slack=state.t_slack + noise(0.5, state.t_slack),
                           p_lambda=noise(0.1, state.p_lambda), t_lambda=noise(0.1, state.t_lambda))
    hull = en.seg_cps(consts, spline).numpy()                     # [P,R,n,3]
    c = rng.normal(size=hull.shape[:2] + (cfg.max_planes, 3))
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    s_min = np.einsum("prjd,prkd->prkj", hull, c).min(-1)
    gap = (1e-5, 1e-3) if edge == "gmw" else (-0.02, 0.15)
    d = -s_min + rng.uniform(*gap, size=s_min.shape)
    mask = rng.random(s_min.shape) < (0.0 if edge == "dead" else 0.5)
    planes = Planes(torch.as_tensor(c, **kw), torch.as_tensor(d, **kw), torch.as_tensor(mask))
    if edge in ("vel", "acc"):
        # |v| / (w t) (|a| / (w^2 t^2)) of the largest term at half the margin
        # below its limit
        w = consts.seg_weight.numpy()[:, None]
        vel = 5.0 * np.diff(hull, axis=2)
        if edge == "vel":
            top = (np.linalg.norm(vel, axis=-1) / w).max()
            t = top / (cfg.vel_limit - cfg.margin / 2)
        else:
            top = (np.linalg.norm(4.0 * np.diff(vel, axis=2), axis=-1) / (w * w)).max()
            t = np.sqrt(top / (cfg.acc_limit - cfg.margin / 2))
        state = state._replace(piece_time=torch.tensor(t, **kw))
    if edge == "nan":
        t_lambda = state.t_lambda.clone()
        t_lambda[DIRECTION_EDGE_PIECE] = float("nan")
        state = state._replace(t_lambda=t_lambda)
    return consts, cfg, state, planes
