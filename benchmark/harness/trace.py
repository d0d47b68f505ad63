"""The device trace of a ``--trace 1`` run, reduced.

The profiler (`torch.profiler`, CPU and CUDA activity) opens in set-up,
before the cell's first capture: CUPTI records no body kernel of a CUDA
graph instantiated before a process's first session.  It records the
first few plans of the window (``trace_plans`` of the mix) between the
benchmark's span ``bench.traced``, then closes; CUPTI faulted past some
330 thousand records in one process, and a plan of the 64-robot cross
runs some 20 thousand kernels.  From the records inside that span:

- ``busy_s``: the union of the device's kernel, copy and fill intervals;
- ``window_s``: the span's length;
- ``kernels``: {kernel name: (executions, device seconds)};
- ``breakdown``: the ten device operations that took most time and the
  ten longest idle gaps, each named by the benchmark's innermost span
  (`system.SPANS`) the host was in when it began.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

WINDOW = "bench.traced"


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    kernels: dict           # name -> [executions, seconds]
    breakdown: dict


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof) -> Trace | None:
    """The trace inside the ``bench.traced`` span, or None when the span or
    the device records are missing."""
    events = prof.events()
    host, device = [], []
    window = None
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.name.startswith("bench."):   # a span's device-side range, not an op
                device.append((start, end, ev.name))
        elif ev.name == WINDOW:
            window = (start, end)
        elif ev.name.startswith("bench."):
            host.append((start, end, ev.name[len("bench."):]))
    if window is None:
        return None
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    if not device:
        return None
    busy = _union([(s, e) for s, e, _ in device])
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for s, e, n in device:
        kernels[n][0] += 1
        kernels[n][1] += (e - s) * 1e-6
    gaps = [(b[0], a[1]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]

    def doing(t):
        inside = [(s, e, n) for s, e, n in host if s <= t < e]
        return min(inside, key=lambda x: x[1] - x[0])[2] if inside else "between requests"

    longest = sorted(((e - s) * 1e-6, doing(s)) for s, e in gaps if e > s)[-10:][::-1]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return Trace(
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        kernels={k: list(v) for k, v in kernels.items()},
        breakdown={"device_ops": [[n[:96], v[1]] for n, v in top],
                   "idle_gaps": [[f"host in {name}", sec] for sec, name in longest]},
    )
