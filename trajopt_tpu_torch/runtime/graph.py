"""Device-side control flow and the fused solve loop (one CUDA graph).

Counterpart of the JAX package's ``lax.cond`` / ``lax.while_loop`` as the
fused drivers use them (`trajopt_tpu/solver/driver.py::solve_fused`,
``solve_fused_multi``, ``solve_fused_multi_cached``).

`device_cond` stands for each ``lax.cond`` of the step.  It has two forms:

- **branch** (the default): a Python branch on ``pred``, one host read of
  it.  The host-stepped drivers and the CPU run this form, so their results
  are those of plain Python control flow.
- **select** (inside `select_form`): both sides run and ``torch.where``
  picks each output leaf, with no host read.  A CUDA graph can hold only
  this form: the torch of the card (2.11) has no conditional graph nodes
  (``CUDAGraph.begin_capture_to_if_node``), so the captured step always
  runs both sides.  ``torch.where`` selects and never multiplies, so a NaN
  or an inf of the side not taken cannot reach the result, and the side
  taken gives the branch form's values bit for bit.

`fixed_rounds` stands for a ``while_loop`` bounded by a round count, and
`run_fused` for the drivers' loop: a block of `STEPS_PER_REPLAY` guarded
steps, each ``device_cond(active, step, nothing)`` with the reference's stop
rule ``(it < max_iters) & ((it <= 1) | (gnorm >= stop))``.  On the CPU the
block runs eagerly; on the card it is captured once into a CUDA graph over
static buffers, after one warm-up of the select form, and replayed until
the flag it writes reads false: one host read per replay and nothing else.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Callable

import torch

from ..ops import _cuda

# Guarded steps per captured block.  Past convergence a captured step still
# does its device work (the select form), and each step in a block costs
# one step of host time to capture, so a block of one step is the cheapest:
# the flag read it adds per iteration is tens of microseconds of a step's
# milliseconds on the card (PERF.md, "K").
STEPS_PER_REPLAY = 1

_SELECT = contextvars.ContextVar("trajopt_select_form", default=False)


@contextlib.contextmanager
def select_form():
    """Run every `device_cond` inside the block in the select form."""
    token = _SELECT.set(True)
    try:
        yield
    finally:
        _SELECT.reset(token)


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped tuples and NamedTuples."""
    first = trees[0]
    if isinstance(first, tuple):
        leaves = [_tree_map(fn, *parts) for parts in zip(*trees, strict=True)]
        return type(first)(*leaves) if hasattr(first, "_fields") else tuple(leaves)
    if not all(torch.is_tensor(t) for t in trees):
        raise TypeError("device_cond: a branch may return only tensors, tuples and NamedTuples "
                        f"of them, got {[type(t).__name__ for t in trees]}")
    return fn(*trees)


def _select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"device_cond: the two sides differ: {tuple(a.shape)} {a.dtype} "
                         f"against {tuple(b.shape)} {b.dtype}")
    return torch.where(pred, a, b)


def device_cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, *operands):
    """``lax.cond(pred, true_fn, false_fn, *operands)`` for a 0-d bool
    tensor ``pred``.  Both sides return tensors (or tuples and NamedTuples
    of them) of the same shapes and dtypes."""
    if _SELECT.get():
        return _tree_map(lambda a, b: _select(pred, a, b),
                         true_fn(*operands), false_fn(*operands))
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def _identity(*carry):
    return carry


def fixed_rounds(rounds: int, pred_fn: Callable, body_fn: Callable, *carry):
    """At most ``rounds`` rounds of ``carry = body_fn(*carry)``, each taken
    while ``pred_fn(*carry)`` holds: a ``lax.while_loop`` bounded by a round
    count.  Each round is ``device_cond(pred, body_fn, identity)``; in the
    branch form the loop ends at the first false predicate, since every
    later round would be the identity (one host read a round, as a Python
    ``while`` makes)."""
    for _ in range(rounds):
        pred = pred_fn(*carry)
        if _SELECT.get():
            carry = device_cond(pred, body_fn, _identity, *carry)
        elif bool(pred):
            carry = body_fn(*carry)
        else:
            break
    return carry


@dataclasses.dataclass
class FusedRun:
    """What the last `run_fused` call did.  ``kernel_nodes`` are the
    launches of each kernel wrapper while the block was captured: the
    kernel nodes of the CUDA graph, each executed once per replay (not
    executions); empty on the CPU.  ``replays`` counts the blocks run (on
    the card: graph replays, one host read each)."""

    device: str
    steps_per_replay: int
    replays: int
    kernel_nodes: dict
    warmup_ms: float
    capture_ms: float
    replay_ms: float


LAST_RUN: FusedRun | None = None


def _active(it: torch.Tensor, gnorm: torch.Tensor, max_iters: int, stop: float) -> torch.Tensor:
    """The reference's loop condition (`trajopt_tpu/solver/driver.py:309-311`)."""
    return (it < max_iters) & ((it <= 1) | (gnorm >= stop))


def _block(step: Callable, max_iters: int, stop: float) -> Callable:
    """``block(carry, it, gnorm) -> (carry, it, gnorm, active)``:
    `STEPS_PER_REPLAY` guarded steps, each ``device_cond(active, step and
    count, nothing)``, so that a step past the stop leaves the carry, ``it``
    and ``gnorm`` as they were, as in the reference's ``while_loop``."""

    def live(carry, it, gnorm):
        carry, g = step(carry)
        return carry, it + 1, g.to(gnorm.dtype)

    def block(carry, it, gnorm):
        for _ in range(STEPS_PER_REPLAY):
            carry, it, gnorm = device_cond(_active(it, gnorm, max_iters, stop), live, _identity,
                                           carry, it, gnorm)
        return carry, it, gnorm, _active(it, gnorm, max_iters, stop)

    return block


def _leaf(tree) -> torch.Tensor:
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree


def _start(carry):
    """The loop's first ``it`` and ``gnorm``: 0 and +inf in the carry's dtype."""
    leaf = _leaf(carry)
    return (torch.zeros((), dtype=torch.int64, device=leaf.device),
            torch.full((), float("inf"), dtype=leaf.dtype, device=leaf.device))


@dataclasses.dataclass
class Captured:
    """One block captured in a CUDA graph over static buffers: ``carry``,
    ``it`` and ``gnorm`` hold the loop's state between replays, ``flag``
    the loop condition after the last one.  It holds the addresses of
    everything the step reads (scene, constants), so it lives for one
    solve."""

    graph: torch.cuda.CUDAGraph
    carry: tuple
    it: torch.Tensor
    gnorm: torch.Tensor
    flag: torch.Tensor
    kernel_nodes: dict
    warmup_ms: float
    capture_ms: float

    def replay(self) -> bool:
        """Run the block once; True while the loop goes on (one host read)."""
        self.graph.replay()
        return bool(self.flag)


def capture(step: Callable, carry, max_iters: int, stop: float) -> Captured:
    """Capture one block of ``step`` (see `run_fused`) in the select form,
    starting from ``carry`` at iteration 0 with gnorm +inf, after one
    warm-up of the same block on a side stream, so that every op of both
    sides runs once before the capture (kernel builds, K1's shared-memory
    opt-in, cached constants, library handles); the warm-up's results are
    dropped."""
    block = _block(step, max_iters, stop)
    it, gnorm = _start(carry)
    static = _tree_map(torch.clone, (carry, it, gnorm))
    flag = torch.full((), max_iters > 0, dtype=torch.bool, device=it.device)
    main = torch.cuda.current_stream(it.device)
    side = torch.cuda.Stream(it.device)
    side.wait_stream(main)
    t0 = time.perf_counter()
    with torch.cuda.stream(side), select_form():
        block(*static)
        t1 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        before = dict(_cuda.LAUNCHES)
        g.capture_begin()
        try:
            *out, out_flag = block(*static)
            _tree_map(lambda s, o: s.copy_(o), static, tuple(out))
            flag.copy_(out_flag)
        finally:
            g.capture_end()
        t2 = time.perf_counter()
    main.wait_stream(side)
    nodes = {name: _cuda.LAUNCHES[name] - before[name] for name in before}
    carry, it, gnorm = static
    return Captured(g, carry, it, gnorm, flag, nodes, (t1 - t0) * 1e3, (t2 - t1) * 1e3)


def run_fused(step: Callable, carry, max_iters: int, stop: float):
    """The fused drivers' loop.  ``step(carry) -> (carry, gnorm)`` advances
    one iteration; ``carry`` is a tuple of tensors (and NamedTuples of
    them) on one device.  Returns (carry, iterations_run, final_gnorm),
    the last two 0-d tensors on that device, gnorm +inf in the carry's
    dtype until the first step.  On the card: `capture`, then replays
    until the flag reads false (one host read each); on the CPU the same
    block runs eagerly."""
    global LAST_RUN
    active = max_iters > 0
    replays = 0
    if _leaf(carry).device.type == "cuda":
        cap = capture(step, carry, max_iters, stop)
        t0 = time.perf_counter()
        while active:
            active = cap.replay()
            replays += 1
        LAST_RUN = FusedRun("cuda", STEPS_PER_REPLAY, replays, cap.kernel_nodes, cap.warmup_ms,
                            cap.capture_ms, (time.perf_counter() - t0) * 1e3)
        return cap.carry, cap.it, cap.gnorm
    block = _block(step, max_iters, stop)
    it, gnorm = _start(carry)
    t0 = time.perf_counter()
    while active:
        carry, it, gnorm, flag = block(carry, it, gnorm)
        replays += 1
        active = bool(flag)
    LAST_RUN = FusedRun("cpu", STEPS_PER_REPLAY, replays, {}, 0.0, 0.0,
                        (time.perf_counter() - t0) * 1e3)
    return carry, it, gnorm
