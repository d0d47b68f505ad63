"""Solver containers as NamedTuples of torch tensors.

Counterpart of `trajopt_tpu/types.py`: same class names, field names and
shapes.  Index tensors are int64 (torch's indexing type) where the JAX
package uses int32.  Every constructor takes an explicit ``device`` and
``dtype``.

`from_numpy` / `to_numpy` convert between the JAX package's containers (or
any NamedTuple whose fields `np.asarray` accepts) and this package's, so
tests can hand both solvers the same state.

`make_scene` and `init_state` are the trace spans ``trajopt.make_scene``
and ``trajopt.init_state`` (`runtime.trace`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops import splines as _sp
from .runtime import trace


class SplineConsts(NamedTuple):
    """Device constants for one trajectory topology (P pieces, R subdivisions,
    n = order+1 control points per piece)."""

    convert: torch.Tensor      # [P, n, n]
    seg_basis: torch.Tensor    # [P, R, n, n]
    seg_weight: torch.Tensor   # [R]
    m_dyn: torch.Tensor        # [n, n]
    time_weight: torch.Tensor  # [P]
    piece_idx: torch.Tensor    # [P, n] int64: stored spline rows per piece

    @property
    def piece_num(self) -> int:
        return self.convert.shape[0]

    @property
    def res(self) -> int:
        return self.seg_basis.shape[1]

    @property
    def n_cp(self) -> int:
        return self.convert.shape[1]

    @property
    def order(self) -> int:
        return self.n_cp - 1

    @property
    def trajectory_num(self) -> int:
        return self.n_cp + (self.piece_num - 1) * (self.order - 2)

    @property
    def whole_weight(self) -> torch.Tensor:
        return self.time_weight.sum()


def device_consts(ops: _sp.SplineOps, *, device, dtype) -> SplineConsts:
    """Upload host-built SplineOps to device constants."""
    conv = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return SplineConsts(
        convert=conv(ops.convert),
        seg_basis=conv(ops.seg_basis),
        seg_weight=conv(ops.seg_weight),
        m_dyn=conv(ops.m_dyn),
        time_weight=conv(ops.time_weight),
        piece_idx=torch.as_tensor(
            _sp.piece_row_index(ops.piece_num, ops.order), dtype=torch.int64,
            device=device,
        ),
    )


class Planes(NamedTuple):
    """Fixed-K separating half-spaces ``c . x + d >= 0`` per subdivided
    segment; ``mask`` marks live slots."""

    c: torch.Tensor     # [P, R, K, 3] unit normals
    d: torch.Tensor     # [P, R, K]
    mask: torch.Tensor  # [P, R, K] bool


def concat_planes(a: Planes, b: Planes) -> Planes:
    """Concatenate plane tables along the slot axis K (any leading axes)."""
    return Planes(
        c=torch.cat([a.c, b.c], dim=-2),
        d=torch.cat([a.d, b.d], dim=-1),
        mask=torch.cat([a.mask, b.mask], dim=-1),
    )


class PlaneCache(NamedTuple):
    """Persistent per-(segment, obstacle id) separating-plane cache of
    ``optimal_plane=True`` (the reference's ``is_seperate / seperate_c``
    tables, CCDUtils.h:64-70): a cached normal warm-starts the barrier-optimal
    refinement (`geometry.refine_plane`), so refinement accumulates across
    iterations.  ``obs_id == -1`` marks an empty slot.  A fleet's cache
    carries a leading robot axis U."""

    obs_id: torch.Tensor  # [P, R, K] int64 obstacle ids
    c: torch.Tensor       # [P, R, K, 3] unit normals


def empty_plane_cache(piece_num: int, res: int, k: int, *, device, dtype) -> PlaneCache:
    return PlaneCache(
        obs_id=torch.full((piece_num, res, k), -1, dtype=torch.int64, device=device),
        c=torch.zeros((piece_num, res, k, 3), dtype=dtype, device=device),
    )


class PairPlaneCache(NamedTuple):
    """Persistent per-(robot, segment, partner robot) pair-plane cache (the
    reference's ``is_self_seperate / self_seperate_c / self_seperate_d``,
    Optimization3D_multi.h:278-327): the refined midplane warm-starts
    `geometry.refine_pair_plane`.  ``partner == -1`` marks an empty slot."""

    partner: torch.Tensor  # [U, P, R, Ks] int64 partner robot ids
    c: torch.Tensor        # [U, P, R, Ks, 3] unit normals (own side positive)
    d: torch.Tensor        # [U, P, R, Ks] midplane offsets


def empty_pair_plane_cache(u: int, piece_num: int, res: int, ks: int, *, device, dtype
                           ) -> PairPlaneCache:
    return PairPlaneCache(
        partner=torch.full((u, piece_num, res, ks), -1, dtype=torch.int64, device=device),
        c=torch.zeros((u, piece_num, res, ks, 3), dtype=dtype, device=device),
        d=torch.zeros((u, piece_num, res, ks), dtype=dtype, device=device),
    )


class Scene(NamedTuple):
    """Static obstacle point cloud (padded to fixed N)."""

    points: torch.Tensor  # [N, 3]
    mask: torch.Tensor    # [N] bool: live points


@trace.traced("trajopt.make_scene")
def make_scene(points: np.ndarray, *, device, dtype, pad_to: int | None = None) -> Scene:
    """Padding rows sit at 1e8, far from any trajectory, and are masked."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    pad_to = pad_to or n
    if pad_to < n:
        raise ValueError(f"pad_to={pad_to} is smaller than the cloud ({n} points)")
    padded = np.full((pad_to, 3), 1e8, dtype=np.float64)
    padded[:n] = pts
    mask = np.zeros(pad_to, dtype=bool)
    mask[:n] = True
    return Scene(
        points=torch.as_tensor(padded, dtype=dtype, device=device),
        mask=torch.as_tensor(mask, device=device),
    )


class SolverState(NamedTuple):
    """Full ADMM state for one robot; a fleet state carries a leading robot
    axis U on every leaf (``piece_time`` [U])."""

    spline: torch.Tensor      # [T, 3] stored control rows
    piece_time: torch.Tensor  # []     scalar time multiplier
    p_slack: torch.Tensor     # [P, n, 3] per-piece slack control points
    t_slack: torch.Tensor     # [P]
    p_lambda: torch.Tensor    # [P, n, 3] duals for the control-point split
    t_lambda: torch.Tensor    # [P]


class StepDiag(NamedTuple):
    """Per-iteration diagnostics."""

    gnorm: torch.Tensor               # reduced-KKT gradient norm
    consensus_residual: torch.Tensor
    step: torch.Tensor                # accepted line-search step
    ccd_step: torch.Tensor            # CCD-clamped max step
    n_planes: torch.Tensor            # live separating planes
    energy: torch.Tensor              # AL spline energy after the update
    infeasible: torch.Tensor          # bool: barrier found an infeasible point
    # bool: more in-radius candidate pairs than plane_gjk_budget GJK slots
    plane_overflow: torch.Tensor | bool = False


class Candidates(NamedTuple):
    """Broad-phase candidate table (`ops.broadphase.topk_candidates`)."""

    idx: torch.Tensor   # [P, R, K] obstacle indices (int64)
    mask: torch.Tensor  # [P, R, K] bool: candidate within query radius
    d2: torch.Tensor    # [P, R, K] squared point-to-AABB distance


@trace.traced("trajopt.init_state")
def init_state(
    ops: _sp.SplineOps,
    way_points: np.ndarray,
    init_piece_time: float = 20.0,
    *,
    device,
    dtype,
    layout: str = "single",
) -> SolverState:
    """Initial ADMM state from waypoints: spline with pinned ends, slack =
    converted spline, duals zero, slack times = ``init_piece_time``."""
    return robot_state(ops, way_points, init_piece_time, device, dtype, layout)


def robot_state(ops: _sp.SplineOps, way_points: np.ndarray, init_piece_time: float, device,
                dtype, layout: str) -> SolverState:
    """`init_state` outside its span (a fleet's `multi.init_multi_state`
    is one span over its robots')."""
    spline = _sp.waypoints_to_spline(way_points, ops.order, layout=layout)
    if spline.shape[0] != ops.trajectory_num:
        raise ValueError(
            f"{len(way_points)} waypoints do not fit a {ops.piece_num}-piece spline"
        )
    idx = _sp.piece_row_index(ops.piece_num, ops.order)
    p_slack = np.einsum("pij,pjd->pid", ops.convert, spline[idx])
    p = ops.piece_num
    kw = dict(dtype=dtype, device=device)
    return SolverState(
        spline=torch.as_tensor(spline, **kw),
        piece_time=torch.tensor(float(init_piece_time), **kw),
        p_slack=torch.as_tensor(p_slack, **kw),
        t_slack=torch.full((p,), float(init_piece_time), **kw),
        p_lambda=torch.zeros((p, ops.order + 1, 3), **kw),
        t_lambda=torch.zeros((p,), **kw),
    )


_CONTAINERS = {
    cls.__name__: cls
    for cls in (SplineConsts, Planes, Scene, SolverState, StepDiag, Candidates, PlaneCache,
                PairPlaneCache)
}


def from_numpy(obj, *, device, dtype):
    """Convert a container of either package into this package's type.

    Each field goes through `np.asarray`; floating fields become ``dtype``,
    integer fields int64, boolean fields stay boolean.
    """
    cls = _CONTAINERS[type(obj).__name__]

    def conv(x):
        a = np.array(x)
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a, dtype=torch.int64, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    return cls(*(conv(x) for x in obj))


def stack(items):
    """Containers of one type stacked field by field on a new leading axis
    (a batch of states or scenes)."""
    return type(items[0])(*(torch.stack(xs) for xs in zip(*items)))


def index(obj, i):
    """Item ``i`` of a container's leading axis, field by field."""
    return type(obj)(*(x[i] for x in obj))


def to_numpy(obj):
    """This package's container with every field as a NumPy array."""
    conv = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return type(obj)(*(conv(x) for x in obj))
