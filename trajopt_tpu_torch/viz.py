"""Offline trajectory visualization — the TPU build's replacement for the
reference's interactive libigl/GLFW viewer (Main/admmPathPlanning3D.cpp:549-835,
enabled there by config ``gui``).

The viewer drew: the obstacle point cloud, each robot's densely resampled
trajectory, the Bezier control polygons, and the start/goal waypoints.  Here
the same picture is rendered headlessly with matplotlib (3D axes) to a PNG —
usable from the CLIs via ``--plot out.png`` — plus a convergence-history
panel (gnorm / consensus residual / energy per iteration, the quantities the
reference prints to stdout each iteration, Optimization3D_admm.h:393-397).

matplotlib is imported lazily and the module degrades to a clear error if it
is unavailable; nothing else in the framework depends on it.

The torch port's own copy of `trajopt_tpu/viz.py`, identical apart from import
paths: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from . import metrics
from .ops import splines as sp


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for trajopt_tpu.viz (headless plotting); "
            "the solver itself does not depend on it"
        ) from e


def plot_scene(
    ops: sp.SplineOps,
    cloud: np.ndarray,
    splines: np.ndarray,
    piece_times: np.ndarray,
    out_path: str,
    waypoints: np.ndarray | None = None,
    max_cloud_points: int = 20000,
    title: str | None = None,
) -> None:
    """Render point cloud + trajectories (+ control polygons) to ``out_path``.

    ``splines``: [T,3] single robot or [U,T,3]; ``piece_times`` scalar or [U].
    """
    plt = _mpl()
    splines = np.asarray(splines, dtype=np.float64)
    if splines.ndim == 2:
        splines = splines[None]
    piece_times = np.broadcast_to(
        np.asarray(piece_times, dtype=np.float64).reshape(-1), (splines.shape[0],)
    )
    cloud = np.asarray(cloud, dtype=np.float64)

    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(111, projection="3d")
    if len(cloud):
        pts = cloud
        if len(pts) > max_cloud_points:
            sel = np.random.default_rng(0).choice(
                len(pts), max_cloud_points, replace=False
            )
            pts = pts[sel]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c="0.6", alpha=0.4,
                   linewidths=0, label=f"cloud ({len(cloud)} pts)")

    cmap = plt.get_cmap("tab10")
    for u in range(splines.shape[0]):
        color = cmap(u % 10)
        traj = metrics.sample_trajectory(ops, splines[u], float(piece_times[u]))
        ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], color=color, lw=2,
                label=f"robot {u}" if splines.shape[0] > 1 else "trajectory")
        ax.plot(splines[u, :, 0], splines[u, :, 1], splines[u, :, 2],
                color=color, lw=0.8, ls="--", alpha=0.6)
        ax.scatter(*traj[0], color=color, marker="o", s=40)
        ax.scatter(*traj[-1], color=color, marker="*", s=80)

    if waypoints is not None:
        wp = np.asarray(waypoints, dtype=np.float64)
        if wp.ndim == 2:
            wp = wp[None]
        for u in range(wp.shape[0]):
            ax.scatter(wp[u, :, 0], wp[u, :, 1], wp[u, :, 2],
                       marker="x", s=30, c="k", alpha=0.7)

    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    if title:
        ax.set_title(title)
    ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_history(history: list[dict], out_path: str) -> None:
    """Convergence panel: gnorm, consensus residual, energy, step sizes."""
    plt = _mpl()
    if not history:
        raise ValueError("empty history")
    its = np.arange(len(history))

    def col(key):
        return np.asarray([h.get(key, np.nan) for h in history], dtype=np.float64)

    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    ax = axes[0, 0]
    ax.semilogy(its, np.maximum(col("gnorm"), 1e-16), label="gnorm")
    ax.semilogy(its, np.maximum(col("consensus_residual"), 1e-16),
                label="consensus residual")
    ax.set_title("convergence"); ax.legend(); ax.set_xlabel("iteration")

    ax = axes[0, 1]
    ax.plot(its, col("energy"))
    ax.set_title("AL energy"); ax.set_xlabel("iteration")

    ax = axes[1, 0]
    ax.plot(its, col("step"), label="accepted step")
    ax.plot(its, col("ccd_step"), label="CCD-safe step", alpha=0.7)
    ax.set_title("line-search steps"); ax.legend(); ax.set_xlabel("iteration")

    ax = axes[1, 1]
    ax.plot(its, col("n_planes"))
    ax.set_title("active separating planes"); ax.set_xlabel("iteration")

    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
