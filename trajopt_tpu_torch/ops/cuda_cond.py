"""Conditional CUDA graph nodes and ``set_condition``, the kernel that sets
their condition on the card (``csrc/graph_cond.cu``).

Replaces what XLA lowers ``lax.cond`` and ``lax.while_loop`` to in the JAX
package's fused drivers: a branch index, or a loop condition, read on the
device from a predicate buffer.  `runtime.graph` builds its conditional
form from these: an IF node (with an ELSE body, or a second IF on the
negated predicate before CUDA 12.8) for each `device_cond`, a WHILE node
for each bounded loop and for the fused drivers' loop.

Plain version of ``set_condition``: the host read of the predicate (the
branch form's ``bool(pred)``), which is what a CPU tensor takes.

Each ``set_condition`` launch also adds, on the card, 1 and the value it
set to a ``tally`` pair of int64 counters, if one is given: the node's
evaluations and the times its body was taken, so that a run can count
how often each body, and each kernel node in it, ran (`runtime.graph`'s
`Captured.executions`).

``mark`` is the tracing's mark between two phases of a captured step
(`runtime.trace`): one thread writes a mark id and the card's
``%globaltimer`` at the next index of a buffer.  It is a measurement aid,
not one of the solve's kernels, so it is not counted in
`_cuda.LAUNCHES`.  Plain version: the same write with the host's
``perf_counter_ns``, which a CPU buffer takes.
"""

from __future__ import annotations

import ctypes
import functools
import time

import torch

from . import _cuda

IF, WHILE = 0, 1
# IF/ELSE (a conditional node of size 2) needs CUDA 12.8 in both the runtime
# and the driver; before it an IF/ELSE is two IF nodes.
IF_ELSE_VERSION = 12080


def set_condition_plain(pred: torch.Tensor, negate: bool = False) -> bool:
    """The value ``set_condition`` gives the node: ``pred`` read on the host."""
    return bool(pred) != negate


def set_condition(handle: int, pred: torch.Tensor, negate: bool = False,
                  tally: torch.Tensor | None = None):
    """Set the condition of the conditional node that owns ``handle`` to the
    0-d bool ``pred`` (negated with ``negate``) when the launch runs, and
    count it in ``tally`` (int64 [2]: evaluations, times set true) if given.

    A CPU ``pred`` takes `set_condition_plain` and returns its value; a CUDA
    ``pred`` launches the kernel on the current stream (which a CUDA graph
    is capturing) or raises."""
    if pred.shape != () or pred.dtype != torch.bool:
        raise ValueError(f"set_condition takes a 0-d bool tensor, got {tuple(pred.shape)} "
                         f"{pred.dtype}")
    if pred.device.type == "cpu":
        return set_condition_plain(pred, negate)
    if pred.device.type != "cuda":
        raise ValueError(f"set_condition: expected a CUDA (or CPU) tensor, got {pred.device}")
    if tally is not None and (tally.dtype != torch.int64 or tally.device != pred.device
                              or tally.shape != (2,)):
        raise ValueError("set_condition: a tally is an int64 [2] tensor on the predicate's device")
    err = _cuda.lib().trajopt_set_condition(handle, pred.data_ptr(), int(negate),
                                            0 if tally is None else tally.data_ptr(),
                                            _cuda.stream())
    _cuda.check_launch(err, "set_condition")
    return None


def mark_plain(marks: torch.Tensor, head: torch.Tensor, mark_id: int) -> None:
    """``mark`` on the host: (``mark_id``, ``perf_counter_ns``) at row
    ``head[0]`` of ``marks`` if it fits, and ``head[0]`` advanced."""
    i = int(head[0])
    head[0] = i + 1
    if i < marks.shape[0]:
        marks[i, 0], marks[i, 1] = mark_id, time.perf_counter_ns()


def mark(marks: torch.Tensor, head: torch.Tensor, mark_id: int) -> None:
    """Write (``mark_id``, the time in ns) at row ``head[0]`` of ``marks``
    (int64 [capacity, 2], contiguous) when the launch runs, and advance
    ``head`` (int64 [1]); a row past the capacity is not written, so
    ``head[0] - capacity`` counts the marks dropped.  A CPU buffer takes
    `mark_plain`; a CUDA one launches the kernel on the current stream."""
    if (marks.dtype != torch.int64 or head.dtype != torch.int64 or marks.dim() != 2
            or marks.shape[1] != 2 or not marks.is_contiguous() or head.shape != (1,)
            or head.device != marks.device):
        raise ValueError("mark: marks is a contiguous int64 [capacity, 2] tensor and head an "
                         "int64 [1] tensor on its device")
    if marks.device.type == "cpu":
        mark_plain(marks, head, mark_id)
        return
    if marks.device.type != "cuda":
        raise ValueError(f"mark: expected a CUDA (or CPU) tensor, got {marks.device}")
    err = _cuda.lib().trajopt_mark(marks.data_ptr(), head.data_ptr(), marks.shape[0], mark_id,
                                   _cuda.stream())
    _cuda.check_error(err, "mark")


@functools.cache
def versions() -> tuple[int, int]:
    """(CUDA runtime version of the kernel library, driver version), as
    ``cudaRuntimeGetVersion`` / ``cudaDriverGetVersion`` give them (12080 is
    12.8)."""
    out = (ctypes.c_int * 2)()
    _cuda.check_error(_cuda.lib().trajopt_cond_probe(out), "cond_probe")
    return out[0], out[1]


def if_else_nodes() -> bool:
    """True when IF nodes can have an ELSE body here (runtime and driver
    >= 12.8); else an IF/ELSE is built as two IF nodes."""
    return min(versions()) >= IF_ELSE_VERSION


def create_handle(stream: int) -> tuple[int, int]:
    """(handle, graph): a conditional handle in the graph that ``stream`` is
    capturing into, reset to 0 at each launch of the graph."""
    handle, graph = ctypes.c_ulonglong(), ctypes.c_void_p()
    _cuda.check_error(_cuda.lib().trajopt_cond_handle(stream, ctypes.byref(handle),
                                                      ctypes.byref(graph)), "cond_handle")
    return handle.value, graph.value


def add_node(stream: int, handle: int, kind: int, size: int = 1) -> list[int]:
    """Add a conditional node on ``handle`` (`IF` with 1 or 2 bodies, or
    `WHILE`) after what ``stream`` has captured, and continue its capture
    after the node; returns the node's body graphs."""
    bodies = (ctypes.c_void_p * 2)()
    _cuda.check_error(_cuda.lib().trajopt_cond_node(stream, handle, kind, size, bodies),
                      "cond_node")
    return [bodies[i] for i in range(size)]


def begin_body(stream: int, body: int) -> None:
    """Capture ``stream`` into the body graph ``body``."""
    _cuda.check_error(_cuda.lib().trajopt_capture_body(stream, body), "capture_body")


def end_body(stream: int) -> int:
    """End the capture of ``stream``; returns the graph it captured into."""
    graph = ctypes.c_void_p()
    _cuda.check_error(_cuda.lib().trajopt_end_body(stream, ctypes.byref(graph)), "end_body")
    return graph.value


def abort_body(stream: int) -> None:
    """End the capture of ``stream`` after a failure inside a body, whatever
    it returns (the failure is what gets raised)."""
    _cuda.lib().trajopt_end_body(stream, ctypes.byref(ctypes.c_void_p()))


def create_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A non-blocking stream of its own on ``device`` (never destroyed), to
    capture bodies on."""
    raw = ctypes.c_void_p()
    with torch.cuda.device(device):
        _cuda.check_error(_cuda.lib().trajopt_stream_create(ctypes.byref(raw)), "stream_create")
    return torch.cuda.ExternalStream(raw.value, device=device)
