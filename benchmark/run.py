#!/usr/bin/env python3
"""The benchmark of `trajopt_tpu_torch`: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA GPUs.  A
run makes the cell's request pool from ``--seed`` (`harness.traffic`),
warms up the cell's shapes, then runs a closed loop of one planner for
``--seconds``: each request hands the program a host-side cloud and
waypoints and waits for the plan on the host (`harness.system`).  It then
frees the program's state, holds a seeded sample of the window's answers
to the plain reference (`harness.check`) and prints, as its last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer ones, from a profiled stretch at the start of the window and
the plans after it), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit (also the last
lines of standard error).

Without a card, or with fewer than the cell asks for, it exits 2 and
prints no result.  ``--rehearse`` runs the cell on the CPU instead, at the
configuration's ``rehearsal`` sizes and in float64, also a ``<config>.<traffic>``
that `BENCHMARK.json` does not list; its metrics are named
``rehearsal.<metric>``, and none is a device's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "trajopt_tpu")   # top-level module names, whole
MIN_TIMED = 3      # plans a traced run times after its profiled ones, at the least


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at the configuration's rehearsal sizes (no device metric)")
    return p.parse_args(argv)


def rehearsal(cell) -> None:
    """The configuration and mix at their CPU rehearsal sizes."""
    over = dict(cell.config.get("rehearsal", {}))
    cell.config["solver"].update(over.pop("solver", {}))
    cell.traffic.update(over.pop("traffic", {}))
    cell.config.update(over)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def failed(answer, cfg) -> bool:
    """A plan that is not finite or did not converge."""
    import numpy as np

    finite = np.isfinite(answer.spline).all() and np.isfinite(answer.piece_time).all()
    return not (finite and math.isfinite(answer.gnorm) and answer.gnorm < cfg.stop
                and answer.iterations < cfg.max_iters)


def clean(x):
    """JSON-safe: a non-finite float as a string."""
    if isinstance(x, dict):
        return {k: clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [clean(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def warm_requests(cell, seed: int):
    """Two requests of the pool's shapes, from cloud seeds apart from the
    pool's: a miss that captures, then a hit."""
    import numpy as np

    from harness import traffic

    rng = np.random.default_rng([abs(seed), 1])
    return [traffic.make_request(cell.config, -1 - i, int(rng.integers(0, 2**63 - 1)))
            for i in range(2)]


def recapture(program, cell, seed: int, device: str) -> None:
    """Drop the program's graphs and free their memory, then warm up again.
    A capture's device time depends on where its buffers land: within one
    process fresh captures of the same solve launched at 4.52-5.09
    ms/iteration (64-robot cross) and 1.99-2.44 (bridge) on one H100, the
    first of a process at 2.40 or near 2.0, so a run that averages several
    captures reads the program and not one placement's luck."""
    import torch

    from trajopt_tpu_torch.runtime import cache

    cache.clear()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for req in warm_requests(cell, seed):
        program.plan(req)
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    args = parse(argv)
    from harness import manifest

    cell = manifest.cell(args.workload, unlisted=args.rehearse)
    import torch

    if args.rehearse:
        rehearsal(cell)
        device, dtype = "cpu", torch.float64
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s), found {count}",
                  file=sys.stderr)
            return 2
        device, dtype = "cuda", getattr(torch, cell.config["dtype"])
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    from harness import check, system, trace, traffic

    config, mix = cell.config, cell.traffic
    prof = None
    if args.trace:
        prof = trace.profiler()
        prof.__enter__()                 # before the first capture (see harness.trace)
    phases = {"imports_s": time.perf_counter() - T_START}
    pool = traffic.make_pool(config, mix, args.seed)
    phases["pool_s"] = time.perf_counter() - T_START - sum(phases.values())
    program = system.System(config, device, dtype)
    for req in warm_requests(cell, args.seed):
        program.plan(req)
    phases["warmup_s"] = time.perf_counter() - T_START - sum(phases.values())
    launch_shapes = system.launch_shapes() if device == "cuda" else {}
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    # the window: a closed loop of one planner over the pool, in
    # ``captures`` stretches; before each but the first the program's graphs
    # are dropped and captured again, off the clock (see `recapture`); the
    # memory a planner holds is the peak at the end of the first stretch
    # (set-up and one capture)
    answers, profiled, window_s, planner_peak = [], 0, 0.0, 0
    captures, per_capture = mix.get("captures", 1), []
    for stretch in range(captures):
        if stretch:
            recapture(program, cell, args.seed, device)
        first, t0 = len(answers), time.perf_counter()
        if prof is not None and stretch == 0:
            program.spans = True
            with torch.profiler.record_function(trace.WINDOW):
                for i in range(mix["trace_plans"]):
                    answers.append(program.plan(pool[i % len(pool)]))
            if device == "cuda":
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            program.spans = False
            profiled = len(answers)
        end = args.seconds * (stretch + 1) / captures - window_s
        while True:
            answers.append(program.plan(pool[len(answers) % len(pool)]))
            if time.perf_counter() - t0 >= end and (stretch + 1 < captures
                                                    or len(answers) - profiled >= MIN_TIMED):
                break
        window_s += time.perf_counter() - t0
        done = answers[max(first, profiled):]
        per_capture.append(sum(a.launch_ms for a in done) / max(sum(a.iterations for a in done), 1))
        if device == "cuda" and not stretch:
            planner_peak = torch.cuda.max_memory_reserved()
    memory_peak = torch.cuda.max_memory_reserved() if device == "cuda" else 0
    reduced = trace.reduce(prof) if prof is not None else None
    program.release()

    # correctness: a seeded sample against the plain reference
    t_check = time.perf_counter()
    ref = check.Reference(config, device)
    rows = []
    for index in check.sample(answers, args.seed, config["check"]["sample"]):
        want = ref.solve(pool[index], "float64")
        seen = {}
        for a in answers:
            if a.index != index:
                continue
            key = (a.iterations, a.spline.tobytes(), a.piece_time.tobytes())
            if key not in seen:
                seen[key] = ref.numbers(check.as_plan(a.iterations, a.spline, a.piece_time),
                                        want, pool[index].cloud)
            rows.append(seen[key])
    correct, checks = check.judge(check.worst(rows), config["check"]["limits"])

    ctx = types.SimpleNamespace(
        answers=answers, timed=answers[profiled:], window_s=window_s, setup_s=setup_s,
        memory_peak_bytes=planner_peak, trace=reduced, launch_shapes=launch_shapes,
        config=config, mix=mix)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.readers[m["name"]](ctx)
        if value is not None:
            name = f"rehearsal.{m['name']}" if args.rehearse else m["name"]
            metrics[name] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 0, "memory_peak_bytes": 0}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": int(memory_peak)}
    if args.trace and reduced is not None and device == "cuda":
        dev.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
    result = {"correct": bool(correct), "attempted": len(answers),
              "failed": sum(failed(a, program.cfg) for a in answers),
              "metrics": metrics, "device": dev}
    if reduced is not None:
        result["breakdown"] = reduced.breakdown
    result["checks"] = checks

    timed = ctx.timed
    its = sum(a.iterations for a in timed) or 1
    print("setup " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; reference check {time.perf_counter() - t_check:.3f} s; window: {len(timed)} plans,"
          f" launch {sum(a.launch_ms for a in timed) / its:.4f} ms/iteration, host"
          f" {sum(a.latency_ms - a.launch_ms for a in timed) / max(len(timed), 1):.3f} ms/plan,"
          f" {sum(not a.hit for a in answers)} graph-cache misses; launch ms/iteration by"
          f" capture: {' '.join(f'{x:.4f}' for x in per_capture)}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process holds JAX or the JAX package: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        (op, limit), = c["limit"].items()
        print(f"check {name} {c['value']!r} {'<=' if op == 'max' else '>='} {limit!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(clean(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
