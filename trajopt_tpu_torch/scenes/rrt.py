"""Host-side RRT-Connect initial-guess planner with greedy shortcutting.

Replaces the reference's OMPL dependency (`HighOrderCCD/OMPL/OMPL.cpp:170-256`
planRRT + `myMotionValidator::checkMotion` edge checks, and `simplify_path`
from Main/admmPathPlanning3D.cpp:154-194).  Pure NumPy + scipy cKDTree; a
C++ implementation lives in `trajopt_tpu.runtime` for large clouds — both are
host-side, outside the jitted hot loop, exactly like OMPL in the reference.

The torch port's own copy of `trajopt_tpu/scenes/rrt.py`, identical apart from import
paths: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


class _EdgeChecker:
    """Edge-vs-cloud and edge-vs-previous-path clearance tests
    (OMPL.cpp:36-101: BVH::EdgeCollision + GJKDCD against points, plus
    segment checks against earlier robots' path edges)."""

    def __init__(self, cloud: np.ndarray, clearance: float, prev_paths=()):
        self.tree = cKDTree(cloud) if len(cloud) else None
        self.clearance = clearance
        self.prev_edges = []
        for path in prev_paths:
            for i in range(len(path) - 1):
                self.prev_edges.append((np.asarray(path[i]), np.asarray(path[i + 1])))

    def point_free(self, p: np.ndarray) -> bool:
        if self.tree is not None and self.tree.query(p)[0] <= self.clearance:
            return False
        for a, b in self.prev_edges:
            if _seg_point_dist(a, b, p) <= self.clearance:
                return False
        return True

    def edge_free(self, a: np.ndarray, b: np.ndarray) -> bool:
        n = max(2, int(np.ceil(np.linalg.norm(b - a) / (0.5 * self.clearance))) + 1)
        pts = a[None] + np.linspace(0, 1, n)[:, None] * (b - a)[None]
        if self.tree is not None:
            d, _ = self.tree.query(pts)
            if (d <= self.clearance).any():
                return False
        for pa, pb in self.prev_edges:
            if _seg_seg_dist(a, b, pa, pb) <= self.clearance:
                return False
        return True


def _seg_point_dist(a, b, p):
    ab = b - a
    t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-12), 0, 1)
    return float(np.linalg.norm(a + t * ab - p))


def _seg_seg_dist(p1, p2, q1, q2):
    """Min distance between two 3D segments (standard clamped closed form)."""
    d1, d2, r = p2 - p1, q2 - q1, p1 - q1
    a, e, f = d1 @ d1, d2 @ d2, d2 @ r
    c, b = d1 @ r, d1 @ d2
    denom = a * e - b * b
    s = np.clip((b * f - c * e) / denom, 0, 1) if denom > 1e-12 else 0.0
    t = (b * s + f) / e if e > 1e-12 else 0.0
    if t < 0:
        t, s = 0.0, np.clip(-c / a, 0, 1) if a > 1e-12 else 0.0
    elif t > 1:
        t, s = 1.0, np.clip((b - c) / a, 0, 1) if a > 1e-12 else 0.0
    return float(np.linalg.norm((p1 + s * d1) - (q1 + t * d2)))


def _extend(tree_pts, tree_parent, target, checker, step):
    """RRT-Connect extend: grow nearest node toward target greedily."""
    pts = np.asarray(tree_pts)
    i = int(np.argmin(np.linalg.norm(pts - target, axis=1)))
    node = pts[i]
    parent = i
    while True:
        d = target - node
        dist = np.linalg.norm(d)
        nxt = target if dist <= step else node + d / dist * step
        if not checker.edge_free(node, nxt):
            return parent, False
        tree_pts.append(nxt)
        tree_parent.append(parent)
        parent = len(tree_pts) - 1
        node = nxt
        if dist <= step:
            return parent, True


def _trace(pts, parent, i):
    out = []
    while i >= 0:
        out.append(pts[i])
        i = parent[i]
    return out[::-1]


def plan_rrt_connect(
    cloud: np.ndarray,
    start: np.ndarray,
    goal: np.ndarray,
    clearance: float,
    bounds: tuple[np.ndarray, np.ndarray] | None = None,
    prev_paths=(),
    step: float = 0.5,
    max_samples: int = 20000,
    seed: int = 0,
) -> np.ndarray | None:
    """Bidirectional RRT-Connect; returns a waypoint polyline or None.

    Bounds default to 1.2x the cloud bbox (ompl_init,
    Main/admmPathPlanning3D.cpp:198-204).
    """
    start, goal = np.asarray(start, float), np.asarray(goal, float)
    checker = _EdgeChecker(cloud, clearance, prev_paths)
    if not (checker.point_free(start) and checker.point_free(goal)):
        return None
    if bounds is None:
        lo = 1.2 * np.minimum(cloud.min(axis=0), np.minimum(start, goal))
        hi = 1.2 * np.maximum(cloud.max(axis=0), np.maximum(start, goal))
    else:
        lo, hi = bounds
    rng = np.random.default_rng(seed)

    ta_pts, ta_par = [start], [-1]
    tb_pts, tb_par = [goal], [-1]
    for it in range(max_samples):
        sample = lo + rng.uniform(size=3) * (hi - lo)
        ia, _ = _extend(ta_pts, ta_par, sample, checker, step)
        target = np.asarray(ta_pts[ia] if ia >= 0 else start)
        # target the node just added (or nearest) from the other tree
        target = np.asarray(ta_pts[-1])
        ib, joined = _extend(tb_pts, tb_par, target, checker, step)
        if joined:
            path_a = _trace(ta_pts, ta_par, len(ta_pts) - 1)
            path_b = _trace(tb_pts, tb_par, ib)
            path = path_a + path_b[::-1]
            return np.asarray(shortcut(path, checker))
        ta_pts, tb_pts = tb_pts, ta_pts
        ta_par, tb_par = tb_par, ta_par
    return None


def shortcut(path, checker) -> list[np.ndarray]:
    """Greedy shortcutting (simplify_path, Main/admmPathPlanning3D.cpp:154-194)."""
    path = [np.asarray(p, float) for p in path]
    out = [path[0]]
    i = 0
    while i < len(path) - 1:
        j = len(path) - 1
        while j > i + 1 and not checker.edge_free(path[i], path[j]):
            j -= 1
        out.append(path[j])
        i = j
    return out


def plan(cloud: np.ndarray, cfg, start=None, goal=None, prev_paths=(), seed=0):
    """CLI-facing wrapper with the single-main's default start/goal
    (Main/admmPathPlanning3D.cpp:222-228) and OMPL-equivalent clearance."""
    start = np.asarray(start if start is not None else [2.7, 0.0, 0.0])
    goal = np.asarray(goal if goal is not None else [-2.7, 0.0, 0.0])
    clearance = cfg.offset + 0.5 * cfg.margin
    path = plan_rrt_connect(
        cloud, start, goal, clearance, prev_paths=prev_paths, seed=seed
    )
    if path is None:
        raise RuntimeError("RRT-Connect found no collision-free initial path")
    return path
