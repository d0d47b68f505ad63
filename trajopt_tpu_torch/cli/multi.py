"""Multi-UAV CLI of the torch port — the `multiPathPlanning3D <mesh>` equivalent.

Usage:
    python -m trajopt_tpu_torch.cli.multi cross.obj --config Config_File/3D.json
    python -m trajopt_tpu_torch.cli.multi --scene cross --uav-num 8        # on CUDA
    python -m trajopt_tpu_torch.cli.multi --scene cross --uav-num 2 --cpu --x64

Same flags, result file and printout as `trajopt_tpu.cli.multi`; the
device is CUDA unless ``--cpu`` is given.  Mode selection follows the
config's ``decouple`` flag (Main/multiPathPlanning3D.cpp:664-678).
``--mesh-devices`` (robot sharding) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh", nargs="?", help="OBJ point cloud under model/multiple/")
    ap.add_argument("--scene", choices=["cross"], help="synthetic scene")
    ap.add_argument("--config", default="Config_File/3D.json")
    ap.add_argument("--init-file", default=None)
    ap.add_argument("--uav-num", type=int, default=4)
    ap.add_argument("--n-pieces", type=int, default=4)
    ap.add_argument("--coupled", action="store_true", help="force coupled mode")
    ap.add_argument("--decoupled", action="store_true", help="force decoupled mode")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="shard robots over this many devices (not ported yet)")
    ap.add_argument("--result-dir", default="result")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="render trajectory + convergence PNGs (offline viewer)")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--n-points", type=int, default=5000)
    ap.add_argument("--x64", action="store_true", help="float64 (CPU debugging)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.mesh_devices:
        raise NotImplementedError("--mesh-devices (robot sharding) is not ported to torch yet")

    import torch

    from .. import metrics as mt
    from .. import types as tt
    from ..config import TrajOptConfig
    from ..ops import splines as sp
    from ..scenes import generators as gen
    from ..scenes import io as sio
    from ..solver import driver, multi as multi_mod

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.x64 else torch.float32
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --cpu to run on the CPU", file=sys.stderr)
        return 2

    cfg = (
        TrajOptConfig.from_json(args.config)
        if os.path.exists(args.config)
        else TrajOptConfig()
    )
    cfg = cfg.replace(ks=1e-3)  # multi main hard-codes ks=1e-3 (multiPathPlanning3D.cpp:596)
    if args.coupled:
        cfg = cfg.replace(decouple=False)
    if args.decoupled:
        cfg = cfg.replace(decouple=True)

    if args.scene == "cross" or args.mesh is None:
        cloud = gen.cross_scene(n_points=args.n_points)
        wps = gen.cross_waypoints(args.uav_num, args.n_pieces)
        name = "cross_synthetic"
    else:
        name = args.mesh
        cloud = sio.read_obj_vertices(os.path.join("model", "multiple", args.mesh)) * 5
        init_path = args.init_file or os.path.join("init", f"{args.mesh}_init_file.txt")
        if os.path.exists(init_path):
            wps = sio.read_multi_waypoints(init_path, scale=5.0)
        else:
            from ..scenes import rrt

            # sequential RRT, each robot avoiding earlier robots' paths
            starts_goals = gen.cross_waypoints(args.uav_num, 1)
            paths = []
            for i in range(args.uav_num):
                p = rrt.plan(cloud, cfg, starts_goals[i, 0], starts_goals[i, -1],
                             prev_paths=paths, seed=i)
                if p is None:
                    print(
                        f"error: RRT found no collision-free path for UAV {i} "
                        f"({starts_goals[i, 0]} -> {starts_goals[i, -1]}); "
                        "provide an init file (--init-file) or adjust the scene",
                        file=sys.stderr,
                    )
                    return 1
                paths.append(p)
            n_max = max(len(p) for p in paths)
            wps = np.stack([np.asarray(rrt_pad(p, n_max)) for p in paths])

    ops = sp.build_spline_ops(wps.shape[1] - 1, cfg.res)
    kw = dict(device=device, dtype=dtype)
    consts = tt.device_consts(ops, **kw)
    scene = tt.make_scene(cloud, **kw)
    state = multi_mod.init_multi_state(ops, wps, cfg.init_piece_time, **kw)

    coupled = not cfg.decouple
    t0 = time.perf_counter()
    state, history = driver.solve_multi(
        consts, cfg, state, scene, coupled=coupled, max_iters=args.max_iters
    )
    whole_ms = (time.perf_counter() - t0) * 1e3

    if args.metrics:
        with open(args.metrics, "w") as fh:
            logger = mt.JsonlLogger(fh)
            for rec in history:
                logger.write(rec)

    os.makedirs(args.result_dir, exist_ok=True)
    result_path = os.path.join(args.result_dir, f"{name}_result_file_admm.txt")
    with open(result_path, "w") as f:
        f.write(f"iter: {len(history)}\n")
        f.write(f"running time: {whole_ms:.0f}\n")
        f.write(f"point cloud size: {len(cloud)}\n")

    splines = state.spline.detach().cpu().double().numpy()
    piece_times = state.piece_time.detach().cpu().double().numpy()
    mode = "coupled" if coupled else "decoupled"
    print(f"uav_num: {wps.shape[0]}  mode: {mode}")
    print(f"iter: {len(history)}")
    print(f"running time: {whole_ms:.0f} ms")
    if history:
        print(f"gnorm: {history[-1]['gnorm']:.4g}")
    for i in range(wps.shape[0]):
        stats = mt.trajectory_stats(ops, splines[i], float(piece_times[i]))
        clearance = mt.min_curve_clearance(ops, splines[i], cloud, float(piece_times[i]))
        print(
            f"uav {i}: ccd time {stats['ccd_time']:.3f}  "
            f"ccd len {stats['ccd_len']:.3f}  clearance {clearance:.3f}"
        )
    print(f"result written to {result_path}")
    if args.plot:
        from .. import viz

        viz.plot_scene(ops, cloud, splines, piece_times, args.plot,
                       waypoints=wps, title=f"{name} ({mode})")
        if history:
            root, ext = os.path.splitext(args.plot)
            viz.plot_history(history, f"{root}_history{ext or '.png'}")
        print(f"plots written to {args.plot}")
    return 0


def rrt_pad(path, n):
    """Pad a waypoint list to length n by subdividing before the last point
    (multi ompl_init padding, Main/multiPathPlanning3D.cpp:313-328)."""
    path = [np.asarray(p, float) for p in path]
    while len(path) < n:
        size = len(path)
        mid = 0.5 * (path[size - 2] + path[size - 1])
        path.insert(size - 1, mid)
    return path


if __name__ == "__main__":
    sys.exit(main())
