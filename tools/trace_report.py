#!/usr/bin/env python3
"""The program's tracing on a benchmark cell: device time by phase of the
fused step, work counters and host spans, and what the switch costs.

    python3 tools/trace_report.py --workload bridge_p4.replan --seed <n> \
        [--stretches 6] [--out trace.json]
    python3 tools/trace_report.py --workload bridge_p4.replan --seed <n> --cpu

from the root of a checkout, on a machine with an NVIDIA GPU (``--cpu``:
the configuration's rehearsal sizes in float64 on the CPU, which gives no
device number).  The cell's configuration, request pool and planner are
the benchmark's (`benchmark/harness`).  In order, in one process:

1. A profiled stretch, the profiler opened before the first capture (CUPTI
   records no body kernel of a graph instantiated before a process's first
   session): with the tracing switch on (`runtime.trace.on`), the two
   warm-up requests (a miss that captures, then a hit) and two plans; the
   mark kernels it holds against ``7 x iterations + 2`` a launch.
2. ``--stretches`` pairs of stretches, switch off then on: each drops the
   graphs, frees their memory, runs the two warm-up requests and then the
   pool once in order.  Every plan of a stretch with the switch on runs in
   a `trace.request`, and its `FusedRun.phases`, `FusedRun.counters` and
   host spans (`trace.drain`) are read after it.

One JSON object is printed last (and written to ``--out``): per stretch
the launch ms an iteration and host ms a plan; the on stretches' phases an
iteration with their sum against the launch's CUDA events, counters an
iteration, whether plans of the same cloud counted the same, the graph's
kernel nodes by wrapper and its IF and WHILE nodes, each wrapper's kernel
executions an iteration (on the card), and the host spans a plan; the
medians of both sides; the card and its power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402
from harness import manifest, system, traffic  # noqa: E402

from trajopt_tpu_torch.runtime import cache, graph, trace  # noqa: E402

INPUT_SPANS = ("trajopt.make_scene", "trajopt.init_state")
SOLVE_SPANS = ("trajopt.solve", "trajopt.cache.key", "trajopt.cache.load",
               "trajopt.graph.launch", "trajopt.cache.clone", "trajopt.graph.warmup",
               "trajopt.graph.capture", "trajopt.graph.instantiate")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--stretches", type=int, default=6)
    p.add_argument("--out")
    p.add_argument("--cpu", action="store_true", help="rehearse on the CPU at small sizes")
    return p.parse_args(argv)


def card() -> dict:
    if not torch.cuda.is_available():
        return {"kind": "cpu (rehearsal)"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()}


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def fresh(program, warm, device: str) -> None:
    """Drop the graphs and their memory, then the warm-up requests."""
    cache.clear()
    sync(device)
    if device == "cuda":
        torch.cuda.empty_cache()
    for req in warm:
        program.plan(req)
    sync(device)


def plan(program, req, on: bool) -> dict:
    """One plan (with the switch ``on``: in a request of its own, with what
    the program recorded of it)."""
    with trace.request() if on else contextlib.nullcontext():
        answer = program.plan(req)
    run = graph.LAST_RUN
    out = {"index": req.index, "iterations": answer.iterations, "launch_ms": answer.launch_ms,
           "latency_ms": answer.latency_ms, "hit": answer.hit, "launch_host_ms": run.host_ms}
    if on:
        spans = collections.defaultdict(float)
        for s in trace.drain():
            spans[s.name] += (s.end_ns - s.start_ns) * 1e-6
        out.update(phases=run.phases(), counters=run.counters(), spans=dict(spans),
                   kernel_nodes=dict(run.kernel_nodes), cond_nodes=dict(run.cond_nodes),
                   executions=run.executions())
    return out


def stretch(program, pool, warm, device: str, on: bool) -> dict:
    with trace.on() if on else contextlib.nullcontext():
        fresh(program, warm, device)
        trace.drain()
        plans = [plan(program, req, on) for req in pool]
    its = sum(p["iterations"] for p in plans)
    out = {"on": on, "plans": len(plans), "iterations": its,
           "launch_ms_per_iter": sum(p["launch_ms"] for p in plans) / its,
           "host_ms_per_plan": sum(p["latency_ms"] - p["launch_ms"] for p in plans) / len(plans),
           "launch_host_ms_per_plan": sum(p["launch_host_ms"] for p in plans) / len(plans),
           "hits": sum(bool(p["hit"]) for p in plans)}
    if on:
        out["traced"] = plans
    return out


def profiled(program, pool, warm, device: str) -> dict:
    """Step 1: mark kernels in a profile against the marks each launch made."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    expected = 0
    with torch.profiler.profile(activities=acts) as prof, trace.on():
        for req in list(warm) + pool[:2]:
            answer = program.plan(req)
            expected += trace.MARKS_PER_STEP * answer.iterations + trace.ROOT_MARKS
        sync(device)
    kernels = [e for e in prof.events() if "trace_mark_kernel" in e.name]
    names = {e.name for e in prof.events()}
    return {"mark_kernels": len(kernels), "marks_expected": expected,
            "spans_seen": sorted(n for n in names if n.startswith("trajopt."))}


def summary(stretches: list) -> dict:
    on = [s for s in stretches if s["on"]]
    off = [s for s in stretches if not s["on"]]
    plans = [p for s in on for p in s["traced"]]
    its = sum(p["iterations"] for p in plans)
    names = trace.PHASES + (trace.LOOP,)
    phases = {k: sum(p["phases"][k] for p in plans) / its for k in names}
    launch = sum(p["launch_ms"] for p in plans) / its
    by_cloud = collections.defaultdict(set)
    for p in plans:
        by_cloud[p["index"]].add(tuple(sorted(p["counters"].items())))
    spans = {k: sum(p["spans"].get(k, 0.0) for p in plans) / len(plans)
             for k in INPUT_SPANS + SOLVE_SPANS}
    med = lambda xs: statistics.median(xs) if xs else None
    return {
        "phases_ms_per_iter": phases,
        "phases_sum_ms_per_iter": sum(phases.values()),
        "launch_ms_per_iter": launch,
        "phases_share_of_launch": sum(phases.values()) / launch,
        "counters_per_iter": {k: sum(p["counters"][k] for p in plans) / its
                              for k in trace.COUNTERS},
        "same_cloud_same_counters": all(len(v) == 1 for v in by_cloud.values()),
        "kernel_nodes": plans[-1]["kernel_nodes"],
        "cond_nodes": plans[-1]["cond_nodes"],
        "executions_per_iter": {k: sum(p["executions"].get(k, 0) for p in plans) / its
                                for k in plans[-1]["executions"]},
        "dropped_marks": sum(p["phases"]["dropped"] for p in plans),
        "spans_ms_per_plan": spans,
        "inputs_host_ms_per_plan": spans["trajopt.make_scene"] + spans["trajopt.init_state"],
        "solve_host_ms_per_plan": spans["trajopt.solve"],
        "launch_ms_per_iter_median": {"off": med([s["launch_ms_per_iter"] for s in off]),
                                      "on": med([s["launch_ms_per_iter"] for s in on])},
        "host_ms_per_plan_median": {"off": med([s["host_ms_per_plan"] for s in off]),
                                    "on": med([s["host_ms_per_plan"] for s in on])},
        "launch_host_ms_per_plan_median": {
            "off": med([s["launch_host_ms_per_plan"] for s in off]),
            "on": med([s["launch_host_ms_per_plan"] for s in on])},
    }


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.cell(args.workload, unlisted=args.cpu)
    if args.cpu:
        from run import rehearsal

        rehearsal(cell)
        device, dtype = "cpu", torch.float64
    else:
        if not torch.cuda.is_available():
            print("trace_report.py: no CUDA device (use --cpu to rehearse)", file=sys.stderr)
            return 2
        device, dtype = "cuda", getattr(torch, cell.config["dtype"])
    from run import warm_requests

    pool = traffic.make_pool(cell.config, cell.traffic, args.seed)
    warm = warm_requests(cell, args.seed)
    program = system.System(cell.config, device, dtype)
    result = {"workload": args.workload, "seed": args.seed, "device": card()}
    result["profiled"] = profiled(program, pool, warm, device)
    stretches = [stretch(program, pool, warm, device, on)
                 for _ in range(args.stretches) for on in (False, True)]
    result["summary"] = summary(stretches)
    result["stretches"] = [{k: v for k, v in s.items() if k != "traced"} for s in stretches]
    program.release()
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**result, "traced": [s.get("traced") for s in stretches]}, f)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
