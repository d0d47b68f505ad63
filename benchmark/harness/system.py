"""The system under test: `trajopt_tpu_torch`'s fused drivers, called as a
planner calls them.

A request runs from the host-side cloud and waypoints to the plan back on
the host: `types.make_scene`, `types.init_state` (one robot) or
`multi.init_multi_state` (a fleet), `driver.solve_fused` or
`driver.solve_fused_multi`, and the read of the splines, piece times,
iterations and final gnorm.  Each of the four is a span of the benchmark's
own (`torch.profiler.record_function`, seen in a traced run).  From the
program the benchmark reads only what it returns, `runtime.graph.LAST_RUN`
and the kernel wrappers' launch counts by shape (`ops._cuda.LAUNCH_SHAPES`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

SPANS = ("make_scene", "init_state", "solve", "read")


@dataclasses.dataclass
class Answer:
    index: int                 # the request's place in the pool
    latency_ms: float          # host clock, cloud handed over to plan on the host
    iterations: int
    gnorm: float
    spline: np.ndarray         # [T, 3] or [U, T, 3]
    piece_time: np.ndarray     # [] or [U]
    hit: bool                  # the graph cache's (`FusedRun.hit`)
    launch_ms: float           # `FusedRun.replay_ms`, between CUDA events


def span(name: str, on: bool):
    return torch.profiler.record_function(f"bench.{name}") if on else contextlib.nullcontext()


class System:
    """The fused solve of one configuration (``configs/<name>.json``), with
    every field of the program's `TrajOptConfig` as the file states it (the
    reference takes the same ``solver`` group)."""

    def __init__(self, config: dict, device: str, dtype: torch.dtype):
        from trajopt_tpu_torch import types as tt
        from trajopt_tpu_torch.config import TrajOptConfig
        from trajopt_tpu_torch.ops import splines as sp

        self.config, self.device, self.dtype = config, device, dtype
        self.cfg = TrajOptConfig(**config["solver"])
        self.ops = sp.build_spline_ops(config["n_pieces"], self.cfg.res)
        self.consts = tt.device_consts(self.ops, device=device, dtype=dtype)
        self.spans = False

    def plan(self, request) -> Answer:
        from trajopt_tpu_torch import types as tt
        from trajopt_tpu_torch.runtime import graph
        from trajopt_tpu_torch.solver import driver, multi

        kw = dict(device=self.device, dtype=self.dtype)
        cfg, config = self.cfg, self.config
        t0 = time.perf_counter()
        with span("make_scene", self.spans):
            scene = tt.make_scene(request.cloud, **kw)
        with span("init_state", self.spans):
            if config["robots"] == 1:
                state = tt.init_state(self.ops, request.waypoints, cfg.init_piece_time, **kw)
            else:
                state = multi.init_multi_state(self.ops, request.waypoints,
                                               cfg.init_piece_time, **kw)
        with span("solve", self.spans):
            if config["robots"] == 1:
                state, it, gnorm = driver.solve_fused(self.consts, cfg, state, scene,
                                                      max_iters=cfg.max_iters)
            else:
                state, it, gnorm = driver.solve_fused_multi(
                    self.consts, cfg, state, scene, coupled=config["coupled"],
                    max_iters=cfg.max_iters)
        with span("read", self.spans):
            spline = state.spline.cpu().numpy()
            piece_time = state.piece_time.cpu().numpy()
            it_gnorm = torch.stack([it.double(), gnorm.double()]).cpu().tolist()
        latency = (time.perf_counter() - t0) * 1e3
        run = graph.LAST_RUN
        return Answer(request.index, latency, int(it_gnorm[0]), it_gnorm[1], spline, piece_time,
                      bool(run.hit), float(run.replay_ms))

    def release(self) -> None:
        """Drop the program's graphs and buffers (before the reference runs)."""
        from trajopt_tpu_torch.runtime import cache

        cache.clear()
        self.consts = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def launch_shapes() -> dict:
    """{(kernel wrapper, call shape): host calls} so far (kernel nodes of the
    captures, and the warm-up's launches)."""
    from trajopt_tpu_torch.ops import _cuda

    return dict(_cuda.LAUNCH_SHAPES)
