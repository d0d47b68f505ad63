#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 [--sample N]
        [--control 3] [--control-precision bfloat16] [--out F]
    python3 benchmark/readings.py --workload <cell> --clouds S1,S2 [--cpu-witness] [--out F]

``<cell>`` may be a ``<config>.<traffic>`` that `BENCHMARK.json` does not
list.  For each seed it makes the run's pool (`harness.traffic`), has the
program plan every request once through the timed path as a run's window
drives it
(warm-up, then the graph cache), draws the run's sample (`check.sample`,
or ``--sample`` requests of it) and holds each sampled answer to the
reference's float64 solve, as `run.py` does.  For the first ``--control``
sampled requests of each seed it also solves them with the control: the
reference put in the program's place in ``--control-precision``.

``--clouds`` reads single requests instead, each from its own cloud seed:
the program's answer twice, the reference's in float64 and in float32,
and with ``--cpu-witness`` the program's own CPU path in float32 (its plain
kernels), a second witness where the program and the reference differ.

It prints one JSON line a seed (or cloud) and writes them all to
``--out``.  A run of the benchmark never runs it.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

import run  # noqa: E402


def robot_gaps(plan, want) -> dict:
    """Median and largest over the robots of each one's path gap (m)."""
    import numpy as np

    gaps = np.linalg.norm(plan.spline - want.spline, axis=-1).max(-1)
    return {"median_path_m": float(np.median(gaps)), "max_path_m": float(gaps.max())}


def read_plan(ref, request, plan, want) -> dict:
    return dict(ref.numbers(plan, want, request.cloud), iterations=plan.iterations,
                robots=robot_gaps(plan, want))


def pool_readings(args, cell, program, ref, device):
    from harness import check, traffic

    config = cell.config
    size = args.sample or config["check"]["sample"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        pool = traffic.make_pool(config, cell.traffic, seed)
        for req in run.warm_requests(cell, seed):
            program.plan(req)
        answers = [program.plan(req) for req in pool]
        row = {"seed": seed, "clouds": [r.seed for r in pool],
               "iterations": [a.iterations for a in answers],
               "latency_ms": [a.latency_ms for a in answers], "program": [], "control": []}
        for n, index in enumerate(check.sample(answers, seed, size)):
            a = answers[index]
            t0 = time.perf_counter()
            want = ref.solve(pool[index], "float64")
            ref_s = time.perf_counter() - t0
            got = read_plan(ref, pool[index], check.as_plan(a.iterations, a.spline, a.piece_time),
                            want)
            row["program"].append(dict(got, index=index, ref_iterations=want.iterations,
                                       reference_s=ref_s))
            if n < args.control:
                t0 = time.perf_counter()
                try:
                    got = read_plan(ref, pool[index], ref.solve(pool[index],
                                                                args.control_precision), want)
                except Exception as exc:      # a control that crashes has failed
                    got = {"error": repr(exc)[:300]}
                row["control"].append(dict(got, index=index, control_s=time.perf_counter() - t0))
        yield row


def cloud_readings(args, cell, program, ref, device):
    import torch

    from harness import check, system, traffic

    config = cell.config
    for cloud in [int(s) for s in args.clouds.split(",")]:
        req = traffic.make_request(config, 0, cloud)
        for warm in run.warm_requests(cell, cloud):
            program.plan(warm)
        answers = [program.plan(req), program.plan(req)]
        want = ref.solve(req, "float64")
        row = {"cloud": cloud, "ref_iterations": want.iterations,
               "program": [read_plan(ref, req, check.as_plan(a.iterations, a.spline,
                                                             a.piece_time), want)
                           for a in answers],
               "same_bits": bool((answers[0].spline == answers[1].spline).all()),
               "reference_float32": read_plan(ref, req, ref.solve(req, "float32"), want)}
        if args.cpu_witness:
            cpu = system.System(config, "cpu", torch.float32)
            a = cpu.plan(req)
            row["program_cpu_float32"] = read_plan(
                ref, req, check.as_plan(a.iterations, a.spline, a.piece_time), want)
            cpu.release()
        yield row


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="comma-separated run seeds")
    p.add_argument("--clouds", default="", help="comma-separated cloud seeds")
    p.add_argument("--sample", type=int, default=0, help="requests a seed (default: a run's)")
    p.add_argument("--control", type=int, default=0, help="sampled requests a seed the control solves")
    p.add_argument("--control-precision", default="bfloat16")
    p.add_argument("--cpu-witness", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)

    import torch

    from harness import check, manifest, system

    cell = manifest.cell(args.workload, unlisted=True)
    if args.rehearse:
        run.rehearsal(cell)
        device, dtype = "cpu", torch.float64
    else:
        if not torch.cuda.is_available():
            print("readings.py: no CUDA device", file=sys.stderr)
            return 2
        device, dtype = "cuda", getattr(torch, cell.config["dtype"])
    program = system.System(cell.config, device, dtype)
    ref = check.Reference(cell.config, device)
    rows = []
    source = cloud_readings if args.clouds else pool_readings
    for row in source(args, cell, program, ref, device):
        rows.append(row)
        print(json.dumps(run.clean(row)), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(run.clean(r)) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
