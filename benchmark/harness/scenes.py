"""Synthetic benchmark scenes.

The reference's benchmark data (bridge.obj, cross.obj point clouds plus
waypoint init files) is distributed out-of-band via a Google Drive link
(`reference/README.md:28`) and is NOT in the repository.  These
generators reproduce the published scene *types*: a bridge-like structure for
the single-UAV run and the antipodal cross-swap pattern whose start/goal pairs
are hard-coded in `Main/multiPathPlanning3D.cpp:251-267`.

The benchmark's frozen copy of `trajopt_tpu_torch/scenes/generators.py` as
of commit 35ea473, unchanged: the benchmark makes every request's inputs
itself, so a later change to the program's generators cannot change them.
"""

from __future__ import annotations

import numpy as np


def sphere_scene(
    n_points: int = 2000,
    radius: float = 1.0,
    center=(0.0, 0.0, 0.0),
    seed: int = 0,
) -> np.ndarray:
    """Point cloud on a sphere — the analytic-solution sanity scene."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n_points, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * radius + np.asarray(center)


def bridge_scene(
    n_points: int = 20000,
    seed: int = 0,
    n_pieces: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """Bridge-like cloud: deck + two towers + arches, spanning x in [-6, 6].

    Returns (points, way_points) where the waypoints thread under the deck
    like the reference's bridge.obj run.  ``n_pieces`` resamples the same
    under-deck path to n_pieces+1 waypoints (long-trajectory benchmarks).
    """
    rng = np.random.default_rng(seed)
    parts = []

    def box(lo, hi, n):
        lo, hi = np.asarray(lo, float), np.asarray(hi, float)
        parts.append(lo + rng.uniform(size=(n, 3)) * (hi - lo))

    n_deck = n_points // 2
    n_tower = n_points // 16
    n_pier = n_points // 16
    # deck
    box([-6, -1.0, 2.0], [6, 1.0, 2.4], n_deck)
    # tower legs (paired, leaving a navigable gap at y ~ 0)
    for sx in (-1, 1):
        for sy in (-1, 1):
            box([sx * 3 - 0.2, sy * 1.0 - 0.2, 0.0],
                [sx * 3 + 0.2, sy * 1.0 + 0.2, 5.0], n_tower)
    # pier legs at the ends
    for sx in (-1, 1):
        for sy in (-1, 1):
            box([sx * 6 - 0.2, sy * 1.0 - 0.2, 0.0],
                [sx * 6 + 0.2, sy * 1.0 + 0.2, 2.0], n_pier)
    # cables (sampled lines from tower tops to deck)
    n_cable = n_points - n_deck - 4 * n_tower - 4 * n_pier
    t = rng.uniform(size=n_cable)
    side = rng.integers(0, 2, n_cable) * 2 - 1
    x0 = side * 3.0
    x1 = side * rng.uniform(3.2, 5.8, n_cable)
    pts = np.stack(
        [
            x0 + t * (x1 - x0),
            rng.uniform(-1, 1, n_cable),
            5.0 + t * (2.4 - 5.0),
        ],
        axis=1,
    )
    parts.append(pts)
    cloud = np.concatenate(parts, axis=0)

    # Fly up and under the deck: the z=1.8 leg sits 0.2 below the deck
    # underside (z=2.0), inside the barrier margin band but outside the hard
    # offset, so separating planes stay active through the solve.
    way_points = np.array(
        [
            [-8.0, 0.0, 0.6],
            [-4.0, 0.0, 1.6],
            [0.0, 0.0, 1.8],
            [4.0, 0.0, 1.6],
            [8.0, 0.0, 0.6],
        ]
    )
    if n_pieces != len(way_points) - 1:
        way_points = resample_polyline(way_points, n_pieces + 1)
    return cloud, way_points


def resample_polyline(wps: np.ndarray, n: int) -> np.ndarray:
    """Resample a waypoint polyline to ``n`` points uniform in arc length."""
    wps = np.asarray(wps, float)
    seg = np.linalg.norm(np.diff(wps, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    t = np.linspace(0.0, s[-1], n)
    out = np.empty((n, 3))
    for d in range(3):
        out[:, d] = np.interp(t, s, wps[:, d])
    return out


def cross_waypoints(
    uav_num: int = 4, n_pieces: int = 4, bulge: float = 1.5
) -> np.ndarray:
    """See `_cross_waypoints_cluster`.  For more than 12 robots the swap is
    tiled as independent 8-robot crossing clusters on a 15-spaced grid —
    keeping every cluster's interior crossing feasible while preserving the
    many-robot compute/communication pattern of the 16-64 robot benchmark
    configs."""
    if uav_num <= 12:
        return _cross_waypoints_cluster(uav_num, n_pieces, bulge)
    clusters = []
    remaining = uav_num
    k = 0
    while remaining > 0:
        take = min(8, remaining)
        grid = np.array([(k % 4) * 40.0, (k // 4) * 40.0, 0.0])
        clusters.append(_cross_waypoints_cluster(take, n_pieces, bulge) + grid)
        remaining -= take
        k += 1
    return np.concatenate(clusters, axis=0)


def _polyline_samples(wp: np.ndarray, n: int = 400) -> np.ndarray:
    ts = np.linspace(0.0, 1.0, n)
    seg = np.minimum((ts * (len(wp) - 1)).astype(int), len(wp) - 2)
    loc = ts * (len(wp) - 1) - seg
    return wp[seg] * (1 - loc[:, None]) + wp[seg + 1] * loc[:, None]


def assign_lanes(
    wps: np.ndarray,
    cloud: np.ndarray | None,
    min_obstacle: float = 0.5,
    min_pairwise: float = 0.5,
    max_radius: float = 8.0,
) -> np.ndarray:
    """Greedy per-robot lane selection, the analytic stand-in for the
    reference's sequential RRT init (each robot's path avoids the scene and
    all earlier robots' paths, OMPL.cpp:82-92).

    ``wps``: [U, W, 3] straight/bulged waypoint polylines from
    `cross_waypoints`-style generators; each robot's interior waypoints are
    re-bulged along its horizontal perpendicular with the first radius whose
    sampled path clears the cloud and all previously assigned robots at equal
    trajectory parameter.
    """
    wps = np.array(wps, dtype=float, copy=True)
    u = wps.shape[0]
    t = np.linspace(0.0, 1.0, wps.shape[1])[:, None]
    chosen: list[np.ndarray] = []
    for i in range(u):
        s, e = wps[i, 0], wps[i, -1]
        d = e - s
        d /= max(np.linalg.norm(d), 1e-9)
        p1 = np.cross(d, [0.0, 0.0, 1.0])
        if np.linalg.norm(p1) < 1e-6:
            p1 = np.cross(d, [0.0, 1.0, 0.0])
        p1 /= np.linalg.norm(p1)
        line = s * (1 - t) + e * t

        best, best_score = None, -np.inf
        radii = [0.0] + [
            sgn * r
            for r in np.arange(1.6, max_radius, 0.4)
            for sgn in ((1, -1) if i % 2 == 0 else (-1, 1))
        ]
        for r in radii:
            cand = line + np.sin(np.pi * t) * (r * p1)[None, :]
            path = _polyline_samples(cand)
            score = np.inf
            if cloud is not None and len(cloud):
                oc = np.linalg.norm(path[:, None] - cloud[None], axis=-1).min()
                score = min(score, oc - min_obstacle)
            for prev in chosen:
                pc = np.linalg.norm(path - prev, axis=1).min()
                score = min(score, pc - min_pairwise)
            if score >= 0:
                best = cand
                break
            if score > best_score:
                best, best_score = cand, score
        wps[i] = best
        chosen.append(_polyline_samples(best))
    return wps


def _cross_waypoints_cluster(
    uav_num: int = 4, n_pieces: int = 4, bulge: float = 1.5
) -> np.ndarray:
    """[U, n_pieces+1, 3] waypoint sets for the antipodal swap.

    The first four start/goal pairs are exactly the hard-coded ones of
    `Main/multiPathPlanning3D.cpp:251-267` scaled by 5 (the multi main scales
    scene and waypoints by 5, multiPathPlanning3D.cpp:107,536); additional
    robots are placed on a circle with antipodal goals.

    Straight connecting lines would make crossing robots *coincide* at equal
    trajectory parameter (pairs 2/3 meet exactly at the center) — an
    infeasible initialization the reference never sees because its sequential
    RRT init avoids earlier robots' paths (OMPL.cpp:82-92).  We reproduce that
    property analytically: each robot's path bulges sideways by ``bulge`` in a
    per-robot direction, giving every robot its own "lane" through the center.
    """
    starts, ends = [], []
    base = [
        ((2.5, 1.7, 0.5), (-2.5, 1.7, 0.5)),
        ((2.5, 1.7, -0.5), (-2.5, 1.7, -0.5)),
        ((-2.5, 1.7, 0.5), (2.5, 1.7, -0.5)),
        ((-2.5, 1.7, -0.5), (2.5, 1.7, 0.5)),
    ]
    for i in range(min(uav_num, 4)):
        s, e = base[i]
        starts.append(np.asarray(s) * 5)
        ends.append(np.asarray(e) * 5)
    for i in range(4, uav_num):
        ang = 2 * np.pi * (i - 4) / max(uav_num - 4, 1) + 0.3
        z = 0.5 * ((i % 3) - 1)
        s = np.array([12.5 * np.cos(ang), 12.5 * np.sin(ang), 2.5 * z])
        starts.append(s)
        ends.append(-s + np.array([0, 0, 2 * 2.5 * z]))
    wps = []
    for i, (s, e) in enumerate(zip(starts, ends)):
        t = np.linspace(0.0, 1.0, n_pieces + 1)[:, None]
        line = s * (1 - t) + e * t
        d = e - s
        d = d / max(np.linalg.norm(d), 1e-9)
        # horizontal perpendicular only: lanes stay clear of the central
        # obstacle column in xy and never dive vertically into it
        p1 = np.cross(d, [0.0, 0.0, 1.0])
        if np.linalg.norm(p1) < 1e-6:
            p1 = np.cross(d, [0.0, 1.0, 0.0])
        p1 /= np.linalg.norm(p1)
        # unique signed magnitude per robot => pairwise-distinct lanes
        radius = (-1.0) ** i * (bulge + 0.45 * bulge / 1.5 * i + 0.55)
        line = line + np.sin(np.pi * t) * (radius * p1)[None, :]
        wps.append(line)
    return np.stack(wps)


def cross_scene(
    n_points: int = 5000, seed: int = 0
) -> np.ndarray:
    """Central obstacle cluster for the cross-swap scene: a tall column at the
    origin ringed by discrete pillars with navigable gaps between them (solid
    geometry would make the antipodal crossing infeasible), scaled like the
    x5 multi scenes."""
    rng = np.random.default_rng(seed)
    n_col = n_points // 2
    col = np.stack(
        [
            rng.uniform(-1.0, 1.0, n_col),
            rng.uniform(-1.0, 1.0, n_col),
            rng.uniform(-4.0, 4.0, n_col),
        ],
        axis=1,
    )
    n_pillar = (n_points - n_col) // 6
    pillars = []
    for k in range(6):
        ang = np.pi / 6 + k * np.pi / 3
        cx, cy = 6.5 * np.cos(ang), 6.5 * np.sin(ang)
        m = n_pillar if k < 5 else (n_points - n_col - 5 * n_pillar)
        pillars.append(
            np.stack(
                [
                    cx + rng.uniform(-0.4, 0.4, m),
                    cy + rng.uniform(-0.4, 0.4, m),
                    rng.uniform(-3.0, 3.0, m),
                ],
                axis=1,
            )
        )
    return np.concatenate([col] + pillars, axis=0)
