"""Trajectory-quality metrics and structured logging.

Reproduces the reference's measurement protocol (BASELINE.md):
`log_data` (Main/admmPathPlanning3D.cpp:33-77) reports the converged total
trajectory time and the arc length of a densely resampled curve; result files
carry iter count / wall time / cloud size (ibid.:507-514).  Here metrics are
also emitted as JSONL for the parity harness.

The torch port's own copy of `trajopt_tpu/metrics.py`, identical apart from import
paths: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from typing import IO

import numpy as np

from . import splines as sp


def sample_trajectory(
    ops: sp.SplineOps, spline: np.ndarray, piece_time: float, dt: float = 0.05
) -> np.ndarray:
    """Densely resample the converted Bezier trajectory.

    Mirrors log_data's sampling: parameter step 0.05 / piece_time over
    [0, piece_num) (Main/admmPathPlanning3D.cpp:59-68).
    """
    spline = np.asarray(spline)
    idx = sp.piece_row_index(ops.piece_num, ops.order)
    bez = np.einsum("pij,pjd->pid", ops.convert, spline[idx])  # [P,n,3]
    ts = np.arange(0.0, ops.piece_num, dt / max(piece_time, 1e-9))
    seg = np.minimum(ts.astype(int), ops.piece_num - 1)
    local = ts - seg
    out = np.empty((len(ts), 3))
    for p in range(ops.piece_num):
        m = seg == p
        if m.any():
            out[m] = sp.bezier_eval(bez[p], local[m], ops.order)
    return out


def trajectory_stats(
    ops: sp.SplineOps, spline: np.ndarray, piece_time: float
) -> dict:
    """``ccd time`` and ``ccd len`` of the reference protocol."""
    pts = sample_trajectory(ops, spline, piece_time)
    length = float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())
    total_time = float(np.asarray(ops.time_weight).sum() * piece_time)
    return {"ccd_time": total_time, "ccd_len": length, "n_samples": len(pts)}


def min_curve_clearance(
    ops: sp.SplineOps,
    spline: np.ndarray,
    points: np.ndarray,
    piece_time: float = 1.0,
    dt: float = 0.02,
    block: int = 4096,
) -> float:
    """Min distance from densely sampled *curve* points to the obstacle cloud.

    The curve lies strictly inside its control hulls, so hull-vertex distance
    is NOT a lower bound on curve clearance — this samples the curve itself
    (the quantity the offset guarantee is about).
    """
    pts = sample_trajectory(ops, spline, piece_time, dt=dt)
    points = np.asarray(points)
    best = np.inf
    for i in range(0, len(pts), block):
        d = np.linalg.norm(pts[i : i + block, None] - points[None], axis=-1)
        best = min(best, float(d.min()))
    return best


class JsonlLogger:
    """Per-iteration metrics stream (replaces the reference's ad-hoc
    result/energy ofstreams, CCDUtils.cpp:20-21)."""

    def __init__(self, fh: IO[str] | None):
        self.fh = fh

    def write(self, record: dict) -> None:
        if self.fh is not None:
            self.fh.write(json.dumps(record) + "\n")
            self.fh.flush()
