"""Bezier spline math as pure functions producing constant arrays.

TPU-native replacement for the reference's precomputed operator tables
(`reference/HighOrderCCD/Utils/CCDUtils.h`):

* `blossom_matrix`      <- `Blossom<order>::coefficient`   (CCDUtils.h:229-315)
* `conversion_matrices` <- `Conversion<order>::convert_matrix` (CCDUtils.h:137-170)
* `dynamic_matrix`      <- `Dynamic3D<order,der>::dynamic_matrix` (CCDUtils.h:172-227)
* `SplineOps`           <- the globals `convert_list`, `subdivide_tree`,
                           `M_dynamic`, `time_weight` (CCDUtils.h:48-62) plus the
                           control-point layout of `init_variable`
                           (Main/admmPathPlanning3D.cpp:249-353)

Everything here runs once on host in float64 NumPy; the resulting tensors are
baked into jaxprs as constants.  Unlike the reference (a vector<tuple> walked
per segment), the subdivision bases are stacked dense tensors `[P, R, n, n]`
so that downstream energy/geometry code is a handful of einsums on the MXU.

Control-point layout (identical to the reference so waypoint/result files
inter-operate): a trajectory with P pieces of order N stores
``T = (N+1) + (P-1)*(N-2)`` rows; piece ``p`` reads rows
``p*(N-2) : p*(N-2) + N+1``, i.e. adjacent pieces share 3 rows for a quintic.
The per-piece conversion matrix blends the shared rows into the piece's true
Bezier control points, enforcing C1/C2 continuity at the joints.

The torch port's own copy of `trajopt_tpu/ops/splines.py`, identical apart from import
paths (and the C++ reference's file paths written relative to its root):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from .config import ORDER


def combination_table(n_max: int) -> np.ndarray:
    """Pascal's triangle up to order ``n_max`` (reference: CCDUtils.h:110-135)."""
    c = np.zeros((n_max + 1, n_max + 1), dtype=np.float64)
    c[:, 0] = 1.0
    for i in range(1, n_max + 1):
        for j in range(1, i + 1):
            c[i, j] = c[i - 1, j - 1] + c[i - 1, j]
    return c


def blossom_matrix(t0: float, t1: float, order: int = ORDER) -> np.ndarray:
    """Subdivision (blossoming) matrix B so that ``B @ cp`` are the control
    points of the curve restricted to ``[t0, t1]``.

    Mirrors the polar-form evaluation of `Blossom<order>::coefficient`
    (CCDUtils.h:229-315): entry (i, j) is the coefficient of control point j in
    the polar form evaluated at ``t0`` repeated ``order - i`` times and ``t1``
    repeated ``i`` times.
    """
    n = order
    comb = combination_table(n)
    m = np.zeros((n + 1, n + 1), dtype=np.float64)
    pow_t0 = np.power(t0, np.arange(n + 1))
    pow_t1 = np.power(t1, np.arange(n + 1))
    pow_1t0 = np.power(1.0 - t0, np.arange(n + 1))
    pow_1t1 = np.power(1.0 - t1, np.arange(n + 1))
    for i in range(n + 1):
        for j in range(n + 1):
            if i + j < n:
                for k in range(min(i, j) + 1):
                    m[i, j] += (
                        comb[n - i, j - k]
                        * comb[i, k]
                        * pow_1t0[n - i - j + k]
                        * pow_1t1[i - k]
                        * pow_t0[j - k]
                        * pow_t1[k]
                    )
            else:
                for k in range(min(n - i, n - j) + 1):
                    m[i, j] += (
                        comb[n - i, k]
                        * comb[i, n - j - k]
                        * pow_1t0[k]
                        * pow_1t1[n - j - k]
                        * pow_t0[n - i - k]
                        * pow_t1[i + j - n + k]
                    )
    return m


def conversion_matrices(time_weight: np.ndarray, order: int = ORDER) -> np.ndarray:
    """Per-piece matrices mapping stored (shared) control rows to true Bezier
    control points with C1/C2 joints (reference: CCDUtils.h:137-170).

    Returns ``[P, order+1, order+1]``.
    """
    tw = np.asarray(time_weight, dtype=np.float64)
    p_num = tw.shape[0]
    n = order
    out = np.tile(np.eye(n + 1, dtype=np.float64), (p_num, 1, 1))
    for i in range(p_num - 1):
        p = tw[i] / (tw[i] + tw[i + 1])
        q = tw[i + 1] / (tw[i] + tw[i + 1])
        i0 = np.array([[q * q, 2 * p * q, p * p], [0.0, q, p]])
        i1 = np.array([[q, p, 0.0], [q * q, 2 * p * q, p * p]])
        out[i, n - 1 : n + 1, n - 2 : n + 1] = i1
        out[i + 1, 0:2, 0:3] = i0
    return out


def dynamic_matrix(order: int = ORDER, der: int = 3) -> np.ndarray:
    """Gram matrix M with ``x^T M x = integral over [0,1] of |d^der B(t)/dt^der|^2``
    for a Bezier curve with control values x (one spatial dimension).

    Closed form per `Dynamic3D<order,der>::dynamic_matrix` (CCDUtils.h:172-227),
    including the 1e-8 ridge the reference adds for strict positive
    definiteness.
    """
    n, k = order, der
    comb = combination_table(2 * n)
    m = np.zeros((n + 1, n + 1), dtype=np.float64)
    fall = 1.0
    for s in range(k):
        fall *= (n - s) * (n - s)
    for i in range(n + 1):
        for j in range(n + 1):
            acc = 0.0
            for k0 in range(k + 1):
                for k1 in range(k + 1):
                    a, b = i - k0, j - k1
                    if 0 <= a <= n - k and 0 <= b <= n - k:
                        sgn = 1.0 if (k0 + k1) % 2 == 0 else -1.0
                        acc += (
                            sgn
                            * comb[k, k0]
                            * comb[k, k1]
                            * comb[n - k, a]
                            * comb[n - k, b]
                            / comb[2 * n - 2 * k, a + b]
                            * fall
                            / (2 * n - 2 * k + 1)
                        )
            m[i, j] = acc
    return m + 1e-8 * np.eye(n + 1)


def bezier_eval(cp: np.ndarray, ts: np.ndarray, order: int = ORDER) -> np.ndarray:
    """Evaluate a Bezier curve at parameters ``ts``; cp is ``[order+1, d]``."""
    comb = combination_table(order)
    ts = np.asarray(ts, dtype=np.float64)[:, None]
    j = np.arange(order + 1)[None, :]
    bern = comb[order, j] * ts**j * (1.0 - ts) ** (order - j)
    return bern @ cp


class SplineOps(NamedTuple):
    """Static per-topology operator bundle (host-built, device constants).

    Attributes:
      convert:    [P, n, n]    stored-rows -> true Bezier CPs per piece
      seg_basis:  [P, R, n, n] blossom(r/R,(r+1)/R) @ convert[p]  — maps stored
                  piece rows directly to each subdivided segment's control hull
                  (reference: `subdivide_tree`, Main/admmPathPlanning3D.cpp:295-341)
      seg_weight: [R]          parameter span of each subdivision (= 1/R)
      m_dyn:      [n, n]       jerk Gram matrix (reference: `M_dynamic`)
      time_weight:[P]          relative piece durations (reference all-ones)
      whole_weight: float      sum of time_weight
      piece_num / res / order / trajectory_num: static ints
    """

    convert: np.ndarray
    seg_basis: np.ndarray
    seg_weight: np.ndarray
    m_dyn: np.ndarray
    time_weight: np.ndarray
    whole_weight: float
    piece_num: int
    res: int
    order: int
    trajectory_num: int

    @property
    def n_cp(self) -> int:
        return self.order + 1

    @property
    def n_free(self) -> int:
        """Free spline rows after pinning 2 rows at each end
        (reference drops them at Optimization3D_admm.h:429-441)."""
        return self.trajectory_num - 4

    @property
    def n_reduced(self) -> int:
        """Dimension of the reduced spline+time KKT system."""
        return 3 * self.n_free + 1


def build_spline_ops(
    piece_num: int,
    res: int,
    order: int = ORDER,
    der: int = 3,
    time_weight: np.ndarray | None = None,
) -> SplineOps:
    if time_weight is None:
        time_weight = np.ones(piece_num, dtype=np.float64)
    time_weight = np.asarray(time_weight, dtype=np.float64)
    assert time_weight.shape == (piece_num,)

    convert = conversion_matrices(time_weight, order)
    seg_basis = np.zeros((piece_num, res, order + 1, order + 1), dtype=np.float64)
    for r in range(res):
        blossom = blossom_matrix(r / res, (r + 1) / res, order)
        for p in range(piece_num):
            seg_basis[p, r] = blossom @ convert[p]
    seg_weight = np.full((res,), 1.0 / res, dtype=np.float64)
    m_dyn = dynamic_matrix(order, der)
    trajectory_num = (order + 1) + (piece_num - 1) * (order - 2)
    return SplineOps(
        convert=convert,
        seg_basis=seg_basis,
        seg_weight=seg_weight,
        m_dyn=m_dyn,
        time_weight=time_weight,
        whole_weight=float(time_weight.sum()),
        piece_num=piece_num,
        res=res,
        order=order,
        trajectory_num=trajectory_num,
    )


def piece_row_index(piece_num: int, order: int = ORDER) -> np.ndarray:
    """[P, order+1] gather indices: stored spline rows used by each piece."""
    starts = np.arange(piece_num) * (order - 2)
    return starts[:, None] + np.arange(order + 1)[None, :]


def waypoints_to_spline(
    way_points: np.ndarray, order: int = ORDER, layout: str = "single"
) -> np.ndarray:
    """Initial stored control rows from waypoints.

    ``layout="single"`` mirrors the single main's `init_variable`
    (Main/admmPathPlanning3D.cpp:255-275, head/tail 0.9/0.1 interpolation);
    ``layout="multi"`` mirrors the multi main's uniform interpolation
    (Main/multiPathPlanning3D.cpp:352-360).  Both pin the ends
    (``spline[1]=spline[0]``, ``spline[T-2]=spline[T-1]``).
    """
    wp = np.asarray(way_points, dtype=np.float64)
    piece_num = wp.shape[0] - 1
    assert piece_num >= 1
    n = order
    t = (n + 1) + (piece_num - 1) * (n - 2)
    spline = np.zeros((t, 3), dtype=np.float64)
    spline[0] = wp[0]
    for i in range(piece_num):
        if layout == "multi":
            for j in range(n - 1):
                a = (n - 2 - j) / (n - 2)
                spline[j + i * (n - 2) + 1] = a * wp[i] + (1.0 - a) * wp[i + 1]
        else:
            head = 0.9 * wp[i] + 0.1 * wp[i + 1]
            tail = 0.9 * wp[i + 1] + 0.1 * wp[i]
            spline[i * (n - 2) + 1] = wp[i]
            for j in range(1, n - 2):
                a = (n - 3 - j) / (n - 4)
                spline[j + i * (n - 2) + 1] = a * head + (1.0 - a) * tail
            spline[(i + 1) * (n - 2) + 1] = wp[i + 1]
    spline[t - 1] = wp[piece_num]
    spline[1] = spline[0]
    spline[t - 2] = spline[t - 1]
    return spline
