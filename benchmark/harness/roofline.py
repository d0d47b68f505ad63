"""The hand-written kernels' least times: a frozen copy of the bound
arithmetic of `chip_smoke.py` phase 5 (`bound_ms` and the operations and
bytes it gives each kernel in `kernel_timings` and `chol_shape_timings`,
as of commit 35ea473), at the call shapes the program's launch counts
name (`ops/_cuda.py::LAUNCH_SHAPES`).

A kernel's share of its roofline in a traced window is the sum of its
executions' least times over their device time.  Executions come from the
trace, by kernel name; a trace does not tell the call shape of an
execution, so each takes the mean least time of the kernel's call shapes,
weighted by the host calls made at each shape (the capture's kernel nodes
and the warm-up's launches).  Each input byte is counted read once and
each output byte written once; the operations are float32.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores

# kernel wrapper -> the substring of its CUDA kernels' names in a trace
TRACE_NAMES = {
    "smallest_k": "smallest_k_",
    "gjk_exact": "gjk_exact_kernel",
    "mod_chol": "mod_chol_kernel",
    "chol_solve": "chol_solve_kernel",
    "factor_solve": "factor_solve_kernel",
}


def bound_s(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the float32
    operations over the float32 peak, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def _numel(dims) -> int:
    return math.prod(int(d) for d in dims)


def call_bound_s(kernel: str, key: tuple) -> float:
    """The least time of one call of ``kernel`` at the launch-count key
    (input shape, parameter name, value)."""
    dims, _, value = key
    numel = _numel(dims)
    if kernel == "smallest_k":
        rows = numel // int(dims[-1])
        return bound_s(numel * 4 + rows * int(value) * 12, numel)
    if kernel == "gjk_exact":
        n, m = int(dims[0]), int(dims[1])
        # one support round a problem at the least (phase 5 counts the
        # rounds each problem took, which a trace cannot see)
        return bound_s(numel * 4 + n * 20, n * (760 + 8 * m))
    m = int(dims[-1])
    n = numel // (m * m)
    if kernel == "mod_chol":
        return bound_s(numel * 4 * (1 + int(value)) + n * m * 4, n * (2 * m ** 3 / 3 + 2 * m ** 2))
    k = _numel(value) // max(n * m, 1)
    rhs_bytes = 2 * _numel(value) * 4
    if kernel == "chol_solve":
        return bound_s(numel * 4 + rhs_bytes, n * k * 2 * m ** 2)
    if kernel == "factor_solve":
        # L is written only when the caller wants it, which the key does
        # not say: it is not counted
        return bound_s(numel * 4 + n * m * 4 + rhs_bytes,
                       n * (2 * m ** 3 / 3 + 2 * m ** 2 + k * 2 * m ** 2))
    raise KeyError(kernel)


def share_pct(kernel: str, launch_shapes: dict, trace) -> float | None:
    """``kernel``'s share of its roofline in the traced window, in %; None
    when the window ran none of it or no call shape of it is known."""
    if trace is None:
        return None
    calls = {key: n for (name, key), n in launch_shapes.items() if name == kernel and key}
    pattern = TRACE_NAMES[kernel]
    runs = [v for name, v in trace.kernels.items() if pattern in name and "probe" not in name]
    executions = sum(v[0] for v in runs)
    seconds = sum(v[1] for v in runs)
    if not calls or executions == 0 or seconds <= 0:
        return None
    mean = sum(n * call_bound_s(kernel, key) for key, n in calls.items()) / sum(calls.values())
    return 100.0 * executions * mean / seconds
