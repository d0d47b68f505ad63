"""The one request generator: a traffic mix's parameters and a
configuration in, a seeded pool of planning requests out.

A request is what a planner hands the system: a point cloud and waypoints,
on the host.  Requests come in a closed loop of one planner, which waits
for each plan before it asks again.  The mix (``traffic/<mix>.json``) sets

- ``pool``: requests made in set-up, each with a cloud of its own from a
  seed drawn from the run's, at the configuration's ``n_points``; the loop
  cycles through them;
- ``captures``: stretches of the window, each over graphs captured anew
  (`run.recapture`);
- ``trace_plans``: the plans a ``--trace 1`` run profiles.

Each cloud comes from the configuration's scene generator (`scenes`, a
frozen copy of the program's).  A fleet's
waypoints are the cross swap's, with lanes assigned to each cloud as
`scenes.assign_lanes` does (`assign_lanes` here gives its result, with a
k-d tree for the distance to the cloud).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree

from . import scenes


@dataclasses.dataclass
class Request:
    index: int              # in the pool
    seed: int               # the cloud's own seed
    cloud: np.ndarray       # [N, 3] float64
    waypoints: np.ndarray   # [W, 3] (single) or [U, W, 3] (fleet)


def assign_lanes(wps: np.ndarray, cloud: np.ndarray, min_obstacle: float = 0.5,
                 min_pairwise: float = 0.5, max_radius: float = 8.0) -> np.ndarray:
    """`scenes.assign_lanes` (the same lanes, bit for bit; a benchmark test
    holds it to it), with the distance from each candidate path to the cloud
    from a k-d tree and to the earlier robots' paths in one array op."""
    wps = np.array(wps, dtype=float, copy=True)
    t = np.linspace(0.0, 1.0, wps.shape[1])[:, None]
    tree = cKDTree(cloud) if len(cloud) else None
    chosen = np.empty((0, 400, 3))
    for i in range(wps.shape[0]):
        s, e = wps[i, 0], wps[i, -1]
        d = e - s
        d /= max(np.linalg.norm(d), 1e-9)
        p1 = np.cross(d, [0.0, 0.0, 1.0])
        if np.linalg.norm(p1) < 1e-6:
            p1 = np.cross(d, [0.0, 1.0, 0.0])
        p1 /= np.linalg.norm(p1)
        line = s * (1 - t) + e * t
        best, best_score = None, -np.inf
        radii = [0.0] + [sgn * r for r in np.arange(1.6, max_radius, 0.4)
                         for sgn in ((1, -1) if i % 2 == 0 else (-1, 1))]
        for r in radii:
            cand = line + np.sin(np.pi * t) * (r * p1)[None, :]
            path = scenes._polyline_samples(cand)
            score = np.inf
            if tree is not None:
                score = min(score, float(tree.query(path)[0].min()) - min_obstacle)
            if len(chosen):
                score = min(score, float(np.linalg.norm(path - chosen, axis=-1).min())
                            - min_pairwise)
            if score >= 0:
                best = cand
                break
            if score > best_score:
                best, best_score = cand, score
        wps[i] = best
        chosen = np.concatenate([chosen, scenes._polyline_samples(best)[None]])
    return wps


def make_request(config: dict, index: int, seed: int) -> Request:
    n_points = config["n_points"]
    if config["scene"] == "bridge":
        cloud, wps = scenes.bridge_scene(n_points=n_points, seed=seed,
                                         n_pieces=config["n_pieces"])
    elif config["scene"] == "cross":
        cloud = scenes.cross_scene(n_points=n_points, seed=seed)
        wps = assign_lanes(scenes.cross_waypoints(config["robots"], config["n_pieces"]), cloud)
    else:
        raise ValueError(f"unknown scene {config['scene']!r}")
    return Request(index, seed, np.ascontiguousarray(cloud), np.ascontiguousarray(wps))


def make_pool(config: dict, mix: dict, seed: int) -> list[Request]:
    """The run's requests: the same ``seed`` gives the same pool."""
    rng = np.random.default_rng(abs(seed))
    seeds = rng.integers(0, 2**63 - 1, size=mix["pool"])
    return [make_request(config, i, int(s)) for i, s in enumerate(seeds)]
