"""The frozen reference against the program it was copied from, and the
request generator's lanes against the frozen generator's."""

import numpy as np
import pytest
import torch

from harness import scenes, traffic
from reference import solve as ref_solve
from reference import multi as ref_multi
from reference import splines as ref_sp
from reference import types as ref_types
from reference.config import TrajOptConfig as RefConfig

KW = dict(device="cpu", dtype=torch.float64)


def test_lanes_match_the_frozen_generator():
    cloud = scenes.cross_scene(n_points=600, seed=5)
    wps = scenes.cross_waypoints(16, 4)
    assert np.array_equal(traffic.assign_lanes(wps, cloud), scenes.assign_lanes(wps, cloud))


def test_pool_is_the_seed():
    """The same seed, the same pool; another seed, other clouds of the same
    size."""
    config = {"scene": "bridge", "n_points": 500, "n_pieces": 4, "robots": 1}
    mix = {"pool": 4}
    a, b = traffic.make_pool(config, mix, 2**31 + 7), traffic.make_pool(config, mix, 2**31 + 7)
    assert [r.index for r in a] == [0, 1, 2, 3]
    assert all(np.array_equal(x.cloud, y.cloud) for x, y in zip(a, b))
    c = traffic.make_pool(config, mix, 2**31 + 8)
    assert {r.cloud.shape for r in a} == {r.cloud.shape for r in c} == {(500, 3)}
    assert not {r.seed for r in a} & {r.seed for r in c}


@pytest.mark.parametrize("name", ["bridge_p4", "cross_u64"])
def test_a_configuration_states_every_solver_field(name):
    """Every field of the program's `TrajOptConfig` and of the reference's is
    in the file's ``solver`` group, so that neither side's defaults decide
    what a cell runs."""
    import dataclasses
    import json

    from harness import manifest
    from trajopt_tpu_torch.config import TrajOptConfig

    solver = json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())["solver"]
    program = {f.name for f in dataclasses.fields(TrajOptConfig)}
    reference = {f.name for f in dataclasses.fields(RefConfig)}
    assert set(solver) == program == reference
    assert dataclasses.asdict(RefConfig(**solver)) == dataclasses.asdict(TrajOptConfig(**solver))


@pytest.mark.parametrize("robots", [1, 3])
def test_reference_is_the_program_on_the_cpu(robots):
    """On the CPU in float64 the frozen copy and `trajopt_tpu_torch`'s fused
    drivers (whose CPU path runs the same plain functions) agree bit for
    bit: the copy changed nothing but its imports."""
    from trajopt_tpu_torch import types as tt
    from trajopt_tpu_torch.config import TrajOptConfig
    from trajopt_tpu_torch.ops import splines as sp
    from trajopt_tpu_torch.runtime import cache
    from trajopt_tpu_torch.solver import driver, multi

    solver = dict(res=8, ks=1e-8 if robots == 1 else 1e-3, max_planes=16, max_self_planes=4,
                  max_ccd_candidates=16)
    if robots == 1:
        cloud, wps = scenes.bridge_scene(n_points=1000, seed=3, n_pieces=4)
    else:
        cloud = scenes.cross_scene(n_points=800, seed=3)
        wps = traffic.assign_lanes(scenes.cross_waypoints(robots, 4), cloud)
    cfg, ops = TrajOptConfig(**solver), sp.build_spline_ops(4, 8)
    consts, scene = tt.device_consts(ops, **KW), tt.make_scene(cloud, **KW)
    if robots == 1:
        got, it, _ = driver.solve_fused(consts, cfg, tt.init_state(ops, wps, 20.0, **KW), scene,
                                        max_iters=30)
    else:
        got, it, _ = driver.solve_fused_multi(consts, cfg, multi.init_multi_state(ops, wps, 20.0,
                                                                                  **KW),
                                              scene, coupled=True, max_iters=30)
    cache.clear()
    rcfg, rops = RefConfig(**solver), ref_sp.build_spline_ops(4, 8)
    rconsts, rscene = ref_types.device_consts(rops, **KW), ref_types.make_scene(cloud, **KW)
    start = (ref_types.init_state(rops, wps, 20.0, **KW) if robots == 1
             else ref_multi.init_multi_state(rops, wps, 20.0, **KW))
    want, rit, _ = ref_solve.solve(rconsts, rcfg, start, rscene,
                                   coupled=None if robots == 1 else True, max_iters=30)
    assert int(it) == rit
    for a, b in zip(got, want):
        assert torch.equal(a, b)
