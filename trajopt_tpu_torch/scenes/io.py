"""Scene and waypoint file I/O, format-compatible with the reference.

* OBJ vertex clouds        <- `Mesh::readOBJ` (CCDUtils.h:317-391; vertices only)
* waypoint init files      <- `way_point_init` (Main/admmPathPlanning3D.cpp:79-112)
                              and the multi-robot column format
                              (Main/multiPathPlanning3D.cpp:80-121)
* result files             <- `result/<mesh>_result_file_admm.txt`
                              (Main/admmPathPlanning3D.cpp:507-514)

The torch port's own copy of `trajopt_tpu/scenes/io.py`, identical apart from import
paths: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def read_obj_vertices(path: str) -> np.ndarray:
    """Vertices-only OBJ reader (faces and everything else ignored)."""
    verts: list[list[float]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
    return np.asarray(verts, dtype=np.float64)


def read_waypoints(path: str, scale: float = 1.0) -> np.ndarray:
    """Single-robot init file: one ``x y z`` row per waypoint -> [W, 3]."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(x) for x in line.split()]
            if len(vals) >= 3:
                rows.append(vals[:3])
    return np.asarray(rows, dtype=np.float64) * scale


def read_multi_waypoints(path: str, scale: float = 1.0) -> np.ndarray:
    """Multi-robot init file: ``uav_num = columns/3`` robots per row
    (Main/multiPathPlanning3D.cpp:89-97); the multi main scales by 5
    (``:107``) — pass ``scale=5`` for parity.  Returns [U, W, 3]."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(x) for x in line.split()]
            if vals:
                rows.append(vals)
    arr = np.asarray(rows, dtype=np.float64)
    u = arr.shape[1] // 3
    return arr.reshape(arr.shape[0], u, 3).transpose(1, 0, 2) * scale


def write_multi_waypoints(path: str, way_points: np.ndarray) -> None:
    """Inverse of `read_multi_waypoints` (written by the multi main's
    ompl_init, Main/multiPathPlanning3D.cpp:330-339)."""
    wp = np.asarray(way_points)
    u, w, _ = wp.shape
    with open(path, "w") as f:
        for i in range(w):
            f.write(" ".join(f"{wp[j, i, k]:.17g}" for j in range(u) for k in range(3)))
            f.write("\n")
