"""Single-UAV CLI of the torch port — the `admmPathPlanning3D <mesh>` equivalent.

Usage:
    python -m trajopt_tpu_torch.cli.single bridge.obj --config Config_File/3D.json
    python -m trajopt_tpu_torch.cli.single --scene bridge        # synthetic scene, on CUDA
    python -m trajopt_tpu_torch.cli.single --scene sphere --cpu --x64

Same flags, result file and printout as `trajopt_tpu.cli.single`; the
device is CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh", nargs="?", help="OBJ point cloud under model/single/")
    ap.add_argument("--scene", choices=["bridge", "sphere"], help="synthetic scene")
    ap.add_argument("--config", default="Config_File/3D.json")
    ap.add_argument("--init-file", default=None, help="waypoint init file")
    ap.add_argument("--result-dir", default="result")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="render trajectory + convergence PNGs (offline viewer)")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--n-points", type=int, default=20000)
    ap.add_argument("--x64", action="store_true", help="float64 (CPU debugging)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from .. import metrics as mt
    from .. import types as tt
    from ..config import TrajOptConfig
    from ..ops import splines as sp
    from ..scenes import generators as gen
    from ..scenes import io as sio
    from ..solver import driver

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

    if args.scene == "bridge" or (args.mesh is None and args.scene is None):
        cloud, way_points = gen.bridge_scene(n_points=args.n_points)
        name = "bridge_synthetic"
    elif args.scene == "sphere":
        cloud = gen.sphere_scene(n_points=args.n_points)
        way_points = np.array(
            [[-3.0, 0, 0], [-1.5, 1.6, 0], [0, 1.8, 0], [1.5, 1.6, 0], [3.0, 0, 0]]
        )
        name = "sphere_synthetic"
    else:
        name = args.mesh
        cloud = sio.read_obj_vertices(os.path.join("model", "single", args.mesh))
        init_path = args.init_file or os.path.join("init", f"{args.mesh}_init_file.txt")
        if cfg.init_mode == 1 and os.path.exists(init_path):
            way_points = sio.read_waypoints(init_path)
        else:
            from ..scenes import rrt

            way_points = rrt.plan(cloud, cfg)

    ops = sp.build_spline_ops(len(way_points) - 1, cfg.res)
    consts = tt.device_consts(ops, device=device, dtype=dtype)
    scene = tt.make_scene(cloud, device=device, dtype=dtype)
    state = tt.init_state(ops, way_points, cfg.init_piece_time, device=device, dtype=dtype)

    metrics_fh = open(args.metrics, "w") if args.metrics else None
    logger = mt.JsonlLogger(metrics_fh)

    t0 = time.perf_counter()
    state, history = driver.solve(consts, cfg, state, scene, max_iters=args.max_iters)
    whole_ms = (time.perf_counter() - t0) * 1e3
    for rec in history:
        logger.write(rec)

    spline = state.spline.detach().cpu().double().numpy()
    piece_time = float(state.piece_time)
    stats = mt.trajectory_stats(ops, spline, piece_time)

    os.makedirs(args.result_dir, exist_ok=True)
    result_path = os.path.join(args.result_dir, f"{name}_result_file_admm.txt")
    with open(result_path, "w") as f:
        f.write(f"iter: {len(history)}\n")
        f.write(f"running time: {whole_ms:.0f}\n")
        f.write(f"point cloud size: {len(cloud)}\n")

    print(f"iter: {len(history)}")
    print(f"running time: {whole_ms:.0f} ms")
    print(f"gnorm: {history[-1]['gnorm']:.4g}" if history else "gnorm: n/a")
    print(f"ccd time: {stats['ccd_time']:.4f}")
    print(f"ccd len: {stats['ccd_len']:.4f}")
    clearance = mt.min_curve_clearance(ops, spline, cloud, piece_time)
    print(f"min curve clearance: {clearance:.4f} (offset {cfg.offset})")
    print(f"point cloud size: {len(cloud)}")
    print(f"result written to {result_path}")
    if args.plot:
        from .. import viz

        viz.plot_scene(ops, cloud, spline, piece_time, args.plot,
                       waypoints=way_points, title=name)
        if history:
            root, ext = os.path.splitext(args.plot)
            viz.plot_history(history, f"{root}_history{ext or '.png'}")
        print(f"plots written to {args.plot}")
    if metrics_fh:
        metrics_fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
