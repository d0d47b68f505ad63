"""Robot and scenario sharding over `torch.distributed`.

Port of `trajopt_tpu/parallel/sharded.py`.  One process per device; a
`DeviceMesh` names its dimensions as the reference's mesh axes:

* ``robot`` (`ROBOT_AXIS`): the fleet's robots split into equal contiguous
  blocks, one per rank.  The step is `solver.multi.multi_admm_step` with
  the robot group as ``axis_name``: the hull all-gather of the pair planes
  and pair CCD, the shared-time Schur sums, the joint CCD min and Armijo
  energies, and the gnorm are collectives over it.
* ``scenario`` (`SCENARIO_AXIS`): independent scenarios, no communication.

Where the reference's `shard_map` takes the global arrays and splits them,
here each rank holds its own shard: `shard_robots` takes a rank's block of
a fleet-wide container and `gather_robots` puts the fleet back together.
Collectives run on NCCL for CUDA tensors and on gloo for CPU tensors; the
mesh's device type chooses the backend.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import TrajOptConfig
from ..solver import driver
from ..solver import multi as multi_mod
from .. import types as tt
from ..types import Scene, SolverState, SplineConsts, StepDiag

ROBOT_AXIS = "robot"
SCENARIO_AXIS = "scenario"


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device_type: str = "cuda",
) -> None:
    """Join the job's default process group: from the arguments (the
    coordinator as ``host:port``), else from the ``torchrun`` environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  A no-op
    when the group exists already, and in a single process with no
    coordinator.  ``device_type`` picks the backend: NCCL for "cuda", gloo
    for "cpu"."""
    if dist.is_initialized():
        return
    backend = _backend(device_type)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed with a coordinator needs num_processes and "
                             "process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    # else one process with no coordinator: nothing to join


def _default_group(device_type: str) -> None:
    """The default group of one process, from an in-memory store (no
    network, no ``torchrun``)."""
    dist.init_process_group(_backend(device_type), store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(n_devices: int | None = None, axis: str = ROBOT_AXIS, *,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh of the job's ``n_devices`` processes (all of them by
    default) named ``axis``.  With one process and no process group yet,
    ``make_mesh(1)`` makes a single-rank group first."""
    if n_devices in (None, 1) and not dist.is_initialized():
        _default_group(device_type)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a job of {n} processes, have {world}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def make_mesh_2d(n_scenario: int, n_robot: int, *, device_type: str = "cuda") -> DeviceMesh:
    """2-D (scenario, robot) mesh: the outer scenario dimension has no
    communication, the inner robot dimension carries the consensus
    collectives (keep it within one host's NVLink domain)."""
    if n_scenario * n_robot == 1 and not dist.is_initialized():
        _default_group(device_type)
    need, world = n_scenario * n_robot, dist.get_world_size()
    if world < need:
        raise ValueError(f"mesh {n_scenario}x{n_robot} needs {need} devices, have {world}")
    if world > need:
        raise ValueError(f"mesh {n_scenario}x{n_robot} spans {need} processes; the job has "
                         f"{world}, and every process holds a shard")
    return init_device_mesh(device_type, (n_scenario, n_robot),
                            mesh_dim_names=(SCENARIO_AXIS, ROBOT_AXIS))


def _robot_group(mesh: DeviceMesh):
    return mesh.get_group(ROBOT_AXIS)


def _slice(tree, lo: int, hi: int):
    if isinstance(tree, tuple):
        return type(tree)(*(_slice(t, lo, hi) for t in tree)) if hasattr(tree, "_fields") \
            else tuple(_slice(t, lo, hi) for t in tree)
    return tree[lo:hi]


def shard_robots(tree, mesh: DeviceMesh, axis: str = ROBOT_AXIS):
    """This rank's block of a container (or tuple of containers) whose
    leaves have a leading fleet axis U: robots ``[r*U/n, (r+1)*U/n)`` for
    its coordinate r of n along ``axis``.  U must divide evenly."""
    leaf = tree
    while isinstance(leaf, tuple):
        leaf = leaf[0]
    u, n = leaf.shape[0], mesh.size(mesh.mesh_dim_names.index(axis))
    if u % n:
        raise ValueError(f"{u} along the {axis} axis do not divide over {n} devices; pad the "
                         "fleet to a multiple of the mesh")
    r = mesh.get_local_rank(axis)
    return _slice(tree, r * (u // n), (r + 1) * (u // n))


def gather_robots(tree, mesh: DeviceMesh, axis: str = ROBOT_AXIS):
    """The inverse of `shard_robots`: every leaf all-gathered along its
    leading axis in rank order (on every rank)."""
    if isinstance(tree, tuple):
        parts = [gather_robots(t, mesh, axis) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return multi_mod._gather_robots(tree, mesh.get_group(axis))


def _check_even(u_local: int, group) -> None:
    """Every rank of the group must hold the same number of robots (the
    all-gathers need equal blocks): one gather of the counts."""
    counts = [None] * dist.get_world_size(group)
    dist.all_gather_object(counts, u_local, group=group)
    if len(set(counts)) != 1:
        raise ValueError(f"robots per rank differ ({counts}): the fleet's U must divide evenly "
                         "over the robot axis")


def sharded_multi_step(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    mesh: DeviceMesh,
    coupled: bool = True,
):
    """The multi-robot ADMM step with the robots sharded over ``mesh``'s
    robot axis: ``step(state_local, scene) -> (state_local, diag)``, where
    ``state_local`` is this rank's block (`shard_robots`; U must divide
    evenly, which the first call checks) and ``diag`` is the fleet's, equal
    on every rank."""
    group = _robot_group(mesh)
    checked = []

    def step(state: SolverState, scene: Scene) -> tuple[SolverState, StepDiag]:
        if not checked:
            _check_even(state.spline.shape[0], group)
            checked.append(True)
        return multi_mod.multi_admm_step(consts, cfg, state, scene, coupled, axis_name=group)

    return step


def sharded_multi_step_2d(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    mesh: DeviceMesh,
    coupled: bool = True,
):
    """The step on a 2-D (scenario, robot) mesh: ``step(states, scenes) ->
    (states, diags)``.  This rank holds B_local scenarios (its block along
    the scenario axis) of U_local robots each (its block along the robot
    axis): ``states`` leaves [B_local, U_local, ...], ``scenes`` leaves
    [B_local, ...] (one obstacle cloud per scenario).  Each scenario is one
    `multi.multi_admm_step` over the robot group; ``diags`` leaves are
    [B_local]."""
    group = _robot_group(mesh)
    checked = []

    def step(states: SolverState, scenes: Scene) -> tuple[SolverState, StepDiag]:
        if not checked:
            _check_even(states.spline.shape[1], group)
            checked.append(True)
        outs = [multi_mod.multi_admm_step(consts, cfg, tt.index(states, i), tt.index(scenes, i),
                                          coupled, axis_name=group)
                for i in range(states.spline.shape[0])]
        return tt.stack([o[0] for o in outs]), tt.stack([o[1] for o in outs])

    return step


def scenario_sharded_solver(
    consts: SplineConsts,
    cfg: TrajOptConfig,
    mesh: DeviceMesh,
    max_iters: int = 200,
):
    """Independent single-UAV solves, each rank solving its own block of
    scenarios along ``mesh``'s scenario axis (`shard_robots(tree, mesh,
    SCENARIO_AXIS)` takes it; no communication): ``solve(states, scenes)
    -> (states, iterations [B_local] int64, gnorm [B_local])`` over this
    rank's ``states`` and ``scenes`` [B_local, ...], each scenario one
    `driver.solve_fused`, stacked.  The mesh must name a scenario axis
    (`make_mesh(n, SCENARIO_AXIS)` or `make_mesh_2d`)."""
    if SCENARIO_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"scenario_sharded_solver needs a mesh with a {SCENARIO_AXIS!r} axis; "
                         f"this one has {mesh.mesh_dim_names}")

    def solve(states: SolverState, scenes: Scene):
        outs = [driver.solve_fused(consts, cfg, tt.index(states, i), tt.index(scenes, i),
                                   max_iters=max_iters)
                for i in range(states.spline.shape[0])]
        return (tt.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    return solve
