"""Device-side control flow and the fused solve loop (one CUDA graph).

Counterpart of the JAX package's ``lax.cond`` / ``lax.while_loop`` as the
fused drivers use them (`trajopt_tpu/solver/driver.py::solve_fused`,
``solve_fused_multi``, ``solve_fused_multi_cached``).

`device_cond` stands for each ``lax.cond`` of the step, `fixed_rounds` for a
``while_loop`` bounded by a round count, and `run_fused` for the drivers'
loop: guarded steps under the reference's stop rule ``(it < max_iters) &
((it <= 1) | (gnorm >= stop))``.  Each has three forms:

- **branch** (the default): a Python branch on ``pred``, one host read of
  it.  The host-stepped drivers and the CPU run this form, so their results
  are those of plain Python control flow.
- **conditional** (inside `conditional_form`): a conditional node of the
  CUDA graph being captured (`CudaNodes`).  `device_cond` is an IF node with
  an ELSE body (CUDA 12.8 and later; before, two IF nodes on ``pred`` and
  ``~pred``), `fixed_rounds` a WHILE node, and `run_fused` one WHILE node
  around the step, so that a fused solve is one graph launch: the side not
  taken never runs and the loop stops at the first false condition, as
  ``lax.cond`` and ``lax.while_loop`` do.  The kernel ``set_condition``
  (`ops.cuda_cond`) sets each node's condition on the card, before an IF
  node and before and at the end of a WHILE node's body.  The true side's
  outputs are allocated in its body and the false side copies its own into
  them; a loop's carry lives in buffers that each round writes back.
  `EagerNodes` is the nodes' CPU stand-in: the same buffers, each condition
  read on the host, the body taken run.  This is the form `run_fused` takes
  on a CUDA tensor.
- **select** (inside `select_form`): both sides run and ``torch.where``
  picks each output leaf, with no host read, so a graph of straight-line
  kernels holds it: a block of `STEPS_PER_REPLAY` guarded steps is captured
  and replayed until the flag it writes reads false (one host read per
  replay).  ``torch.where`` selects and never multiplies, so a NaN or an
  inf of the side not taken cannot reach the result, and the side taken
  gives the branch form's values bit for bit.  `run_fused(form="select")`
  keeps it, to measure what the conditional form saves; the warm-up before
  every capture runs it, so that every op of both sides runs once before
  the capture.

A captured solve (`Captured`) reads its start from input buffers of its
own and the step's constants and scene at the addresses it was captured
with, so it can be launched again after new values are copied into them.
`run_fused` captures anew at each call, for callers that pass their own
step; the fused drivers go through `runtime.cache`, which keeps one
captured solve per key and launches it again (`launch`).

Under the tracing switch (`runtime.trace.on`) a capture in the conditional
form also holds the marks and counters of `runtime.trace` as kernel nodes
writing into a buffer of its own (`DeviceRecorder`) and the nodes' tallies
(`FusedRun.executions`); `FusedRun.phases` and `FusedRun.counters` read
them back after a launch.  On the CPU the marks read the host's clock.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
from typing import Callable

import torch

from ..ops import _cuda, cuda_cond
from . import trace

# Guarded steps per captured block of the select form.  Past convergence a
# captured step still does its device work, and each step in a block costs
# one step of host time to capture, so a block of one step is the cheapest:
# the flag read it adds per iteration is tenths of a millisecond of a
# step's milliseconds on the card (PERF.md, section 5).
STEPS_PER_REPLAY = 1

# Bodies nest at most this deep, one capture stream a level: the solve's
# WHILE holds the decoupled shrink's WHILE and its certify IF (3 levels),
# and the Armijo IF with the staged ladder's IFs, one a stage (5 levels).
MAX_DEPTH = 12
# Conditional nodes (rows of set_condition tallies) a counted capture may hold.
MAX_NODES = 1024

FORMS = ("branch", "conditional", "select")

# None: the branch form; "select"; or the nodes of the conditional form.
_FORM = contextvars.ContextVar("trajopt_graph_form", default=None)


@contextlib.contextmanager
def _in_form(value):
    token = _FORM.set(value)
    try:
        yield
    finally:
        _FORM.reset(token)


@contextlib.contextmanager
def select_form():
    """Run every `device_cond` and `fixed_rounds` inside the block in the
    select form, which records no trace mark or count."""
    with _in_form("select"), trace.recording(None):
        yield


def conditional_form(nodes):
    """Run every `device_cond` and `fixed_rounds` inside the block in the
    conditional form, on ``nodes`` (`CudaNodes` or `EagerNodes`)."""
    return _in_form(nodes)


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


def _leaves(tree) -> list:
    return [x for part in tree for x in _leaves(part)] if isinstance(tree, tuple) else [tree]


def _same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"device_cond: the two sides differ: {tuple(a.shape)} {a.dtype} "
                         f"against {tuple(b.shape)} {b.dtype}")
    return a


def _select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(pred, _same(a, b), b)


def _copy_into(out: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return _same(out, value).copy_(value)


def device_cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, *operands):
    """``lax.cond(pred, true_fn, false_fn, *operands)`` for a 0-d bool
    tensor ``pred``.  Both sides return tensors (or tuples and NamedTuples
    of them) of the same shapes and dtypes."""
    form = _FORM.get()
    if form is None:
        return true_fn(*operands) if bool(pred) else false_fn(*operands)
    if form == "select":
        return _tree_map(lambda a, b: _select(pred, a, b),
                         true_fn(*operands), false_fn(*operands))
    out = []

    def then():
        out.append(_tree_map(torch.clone, true_fn(*operands)))

    def orelse():
        value = false_fn(*operands)
        if not out:                  # the stand-in ran no true side
            out.append(_tree_map(torch.empty_like, value))
        _tree_map(_copy_into, out[0], value)

    form.cond(pred, then, orelse)
    return out[0]


def _identity(*carry):
    return carry


def fixed_rounds(rounds: int, pred_fn: Callable, body_fn: Callable, *carry):
    """At most ``rounds`` rounds of ``carry = body_fn(*carry)``, each taken
    while ``pred_fn(*carry)`` holds: a ``lax.while_loop`` bounded by a round
    count.  In the branch form the loop ends at the first false predicate
    (one host read a round, as a Python ``while`` makes); in the select form
    each round is ``device_cond(pred, body_fn, identity)``; in the
    conditional form it is a WHILE node whose condition folds in a round
    counter on the card."""
    form = _FORM.get()
    if form is not None and form != "select":
        start = torch.zeros((), dtype=torch.int64, device=_leaf(carry).device)
        return _while(form, lambda r, *c: pred_fn(*c) & (r < rounds),
                      lambda r, *c: (r + 1, *body_fn(*c)), (start, *carry))[1:]
    for _ in range(rounds):
        pred = pred_fn(*carry)
        if form == "select":
            carry = device_cond(pred, body_fn, _identity, *carry)
        elif bool(pred):
            carry = body_fn(*carry)
        else:
            break
    return carry


def _write_back(buffers, new) -> None:
    """Copy a loop body's new carry into the loop's buffers.  A new leaf
    that is (a view of) another buffer would be overwritten before it is
    read, so such a leaf is copied to a temporary first."""
    _tree_map(_same, buffers, new)
    dst, src = _leaves(buffers), _leaves(new)
    held = {d.untyped_storage().data_ptr() for d in dst}
    src = [s if s is d or s.untyped_storage().data_ptr() not in held else s.clone()
           for d, s in zip(dst, src)]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


def _while(nodes, cond_fn: Callable, body_fn: Callable, carry: tuple) -> tuple:
    """``lax.while_loop(cond_fn, body_fn, carry)`` on ``nodes``: the carry
    is cloned into buffers, which each round of the body updates in place
    and which hold the result."""
    buffers = _tree_map(torch.clone, carry)
    nodes.loop(lambda: cond_fn(*buffers), lambda: _write_back(buffers, body_fn(*buffers)))
    return buffers


class EagerNodes:
    """The conditional form's CPU stand-in for the nodes: each condition
    read on the host (`cuda_cond.set_condition`'s plain version, which a
    CPU predicate takes), then the body taken run, through the same buffers
    as on the card."""

    @staticmethod
    def _read(pred: torch.Tensor) -> bool:
        if pred.device.type != "cpu":
            raise ValueError(f"EagerNodes stands in for the nodes on the CPU, got {pred.device}")
        return cuda_cond.set_condition(0, pred)

    def cond(self, pred, then, orelse):
        (then if self._read(pred) else orelse)()

    def loop(self, cond, body):
        while self._read(cond()):
            body()


@dataclasses.dataclass
class _Body:
    """A body graph: the tally row and the count (0: evaluations, 1: times
    true) whose difference from the first count, or itself, gives its
    executions, and the kernel wrappers' launches captured in it directly."""

    row: int
    taken: bool
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)


class CudaNodes:
    """Builds the conditional form's nodes while a CUDA graph is captured on
    the current stream: each node after a ``set_condition`` launch that sets
    its condition, each body captured on a stream of its own nesting depth
    (``streams``) into the node's body graph.  ``tallies`` (int64
    [MAX_NODES, 2] on the card, or None: no count) get each node's
    evaluations and times true.

    torch routes a capture's allocations to the graph's memory pool by the
    capture id of the stream, which a body's capture does not share, and
    takes one routing a pool at a time.  So for the rest of the capture the
    nodes route every allocation on the device to the graph's pool ``pool``
    instead, from any thread and stream (torch's ``capture_end`` ends that
    routing).  Any thread: the autograd engine runs the backward passes of
    the step's ``torch.func.grad`` on a thread of its own, so a routing of
    this thread's allocations alone left theirs in the shared pool, which
    handed that memory out again after the capture while the graph still
    used it (PERF.md, section 6)."""

    def __init__(self, device: torch.device, pool, streams: list, tallies: torch.Tensor | None,
                 if_else: bool | None = None):
        self.streams, self.tallies = streams, tallies
        torch._C._cuda_endAllocateToPool(device.index, pool)
        torch._C._cuda_beginAllocateToPool(device.index, pool)
        torch._C._cuda_releasePool(device.index, pool)     # the routing holds no use of it
        runtime, driver = cuda_cond.versions()
        self.if_else = cuda_cond.if_else_nodes() if if_else is None else if_else
        if self.if_else and not cuda_cond.if_else_nodes():
            raise ValueError(f"IF/ELSE nodes need CUDA {cuda_cond.IF_ELSE_VERSION} (runtime "
                             f"{runtime}, driver {driver})")
        self.versions = {"runtime": runtime, "driver": driver, "if_else": self.if_else}
        self.counts = collections.Counter()       # "if", "while" nodes
        self.root = None                          # the graph depth 0 captures into
        self.records: list[_Body] = []
        self._stack: list[_Body] = []
        self._rows = 0

    def _raw(self) -> int:
        return _cuda.stream()

    def _tally(self, row: int) -> torch.Tensor | None:
        return None if self.tallies is None else self.tallies[row]

    def _set(self, pred: torch.Tensor, negate: bool = False) -> tuple[int, int]:
        """A new handle, its condition set from ``pred``; (handle, tally row)."""
        handle, graph = cuda_cond.create_handle(self._raw())
        if not self._stack:
            if self.root is not None and graph != self.root:
                raise RuntimeError("conditional node: the capture moved to another graph")
            self.root = graph
        if self.tallies is not None and self._rows == len(self.tallies):
            raise RuntimeError(f"a counted capture holds at most {len(self.tallies)} "
                               "conditional nodes")
        row, self._rows = self._rows, self._rows + 1
        cuda_cond.set_condition(handle, pred, negate, self._tally(row))
        return handle, row

    def _body(self, body: int, fn: Callable, record: _Body, kind: str) -> None:
        depth = len(self._stack)
        if depth >= len(self.streams):
            raise RuntimeError(f"conditional bodies nest deeper than {len(self.streams)}")
        stream = self.streams[depth]
        raw = stream.cuda_stream
        before = dict(_cuda.LAUNCHES)
        self._stack.append(record)
        with torch.cuda.stream(stream):
            cuda_cond.begin_body(raw, body)
            try:
                fn()
            except BaseException as exc:
                cuda_cond.abort_body(raw)       # then raise what failed
                self._stack.pop()
                exc.add_note(f"inside the body of a conditional {kind} node at depth {depth}")
                raise
            if cuda_cond.end_body(raw) != body:
                raise RuntimeError("conditional node: a body was captured into another graph")
        self._stack.pop()
        total = collections.Counter({k: _cuda.LAUNCHES[k] - before[k] for k in before})
        record.launches.update({k: v for k, v in total.items() if v})
        if self._stack:    # the enclosing body's direct launches leave this one's out
            self._stack[-1].launches.subtract(total)
        self.records.append(record)

    def cond(self, pred, then, orelse):
        if self.if_else:
            handle, row = self._set(pred)
            then_body, else_body = cuda_cond.add_node(self._raw(), handle, cuda_cond.IF, 2)
            self._body(then_body, then, _Body(row, True), "IF")
            self._body(else_body, orelse, _Body(row, False), "IF/ELSE")
            self.counts["if"] += 1
            return
        # two IF nodes, both conditions set before either body runs
        handle, row = self._set(pred)
        not_handle, not_row = self._set(pred, negate=True)
        (then_body,) = cuda_cond.add_node(self._raw(), handle, cuda_cond.IF, 1)
        self._body(then_body, then, _Body(row, True), "IF")
        (else_body,) = cuda_cond.add_node(self._raw(), not_handle, cuda_cond.IF, 1)
        self._body(else_body, orelse, _Body(not_row, True), "IF (not)")
        self.counts["if"] += 2

    def loop(self, cond, body):
        handle, row = self._set(cond())
        (loop_body,) = cuda_cond.add_node(self._raw(), handle, cuda_cond.WHILE, 1)

        def run():
            body()
            cuda_cond.set_condition(handle, cond(), tally=self._tally(row))

        self._body(loop_body, run, _Body(row, True), "WHILE")
        self.counts["while"] += 1


_BODY_STREAMS: dict = {}


def _body_streams(device: torch.device) -> list:
    """The body capture streams of ``device``, one a nesting depth, made
    once for the process (a library op that keeps per-stream state, such as
    cuBLAS's workspace, then finds the same streams in every capture)."""
    if device.index not in _BODY_STREAMS:
        _BODY_STREAMS[device.index] = [cuda_cond.create_stream(device) for _ in range(MAX_DEPTH)]
    return _BODY_STREAMS[device.index]


class DeviceRecorder:
    """A traced capture's marks and counters on the card (`runtime.trace`):
    one int64 buffer holding the next mark's index, the `trace.COUNTERS`
    and ``capacity`` (mark id, ``%globaltimer`` ns) pairs.  `reset` runs
    at the graph's start, so each launch records its own; a mark past the
    capacity is dropped and counted by the index running on.  Read it on
    the host after the launch has ended."""

    def __init__(self, device: torch.device, capacity: int):
        self.capacity = capacity
        n = len(trace.COUNTERS)
        self.buf = torch.zeros(1 + n + 2 * capacity, dtype=torch.int64, device=device)
        self._head, self._counters = self.buf[:1], self.buf[1:1 + n]
        self._marks = self.buf[1 + n:].view(capacity, 2)

    def reset(self) -> None:
        self.buf[:1 + len(trace.COUNTERS)].zero_()

    def mark(self, mark_id: int) -> None:
        cuda_cond.mark(self._marks, self._head, mark_id)

    def count(self, name: str, value) -> None:
        row = self._counters[trace.COUNTERS.index(name)]
        row.add_(value.to(torch.int64) if torch.is_tensor(value) else value)

    def dropped(self) -> int:
        return max(int(self._head) - self.capacity, 0)

    def marks(self) -> list:
        n = min(int(self._head), self.capacity)
        return [tuple(m) for m in self._marks[:n].tolist()]

    def counters(self) -> dict:
        return dict(zip(trace.COUNTERS, self._counters.tolist()))


@dataclasses.dataclass
class FusedRun:
    """What the last `run_fused` call did.  ``form``: branch (the CPU),
    select or conditional.  ``replays`` counts the blocks run: on the card
    graph launches (select: one host read each; conditional: 1 a solve, no
    read).  ``kernel_nodes`` are the launches of each kernel wrapper while
    the graph was captured: its kernel nodes, ``set_condition``'s included
    (select: each runs once per replay; conditional: 0 or more times a
    launch, see `executions`); empty on the CPU.  ``cond_nodes``: the IF and
    WHILE nodes.  ``warmup_ms``, ``capture_ms`` and ``instantiate_ms``: the
    graph's warm-up, capture and ``instantiate`` on the host clock;
    ``pool_bytes``: the growth of ``torch.cuda.memory_reserved`` across the
    capture and instantiation (the graph's private pool).  ``hit``: the
    solve launched a graph that `runtime.cache` captured in an earlier call
    (warm-up, capture and instantiation 0; ``replays`` and ``events`` this
    call's, the rest the graph's).  ``recorder``: where the solve's trace
    marks and counts went (`DeviceRecorder`, or on the CPU a
    `trace.HostRecorder`); None outside `trace.on` and in the select form."""

    device: str
    form: str
    steps_per_replay: int | None
    replays: int
    kernel_nodes: dict
    warmup_ms: float
    capture_ms: float
    host_ms: float
    events: tuple | None = None
    cond_nodes: dict = dataclasses.field(default_factory=dict)
    versions: dict = dataclasses.field(default_factory=dict)
    tallies: torch.Tensor | None = None
    bodies: list = dataclasses.field(default_factory=list)
    root_launches: dict = dataclasses.field(default_factory=dict)
    instantiate_ms: float = 0.0
    pool_bytes: int = 0
    hit: bool = False
    recorder: object = None

    @property
    def replay_ms(self) -> float:
        """ms from the first launch to the end of the loop: between CUDA
        events around the one launch of the conditional form (read once the
        caller has synchronized), else on the host clock (select: the flag
        reads included)."""
        if self.events is None:
            return self.host_ms
        return self.events[0].elapsed_time(self.events[1])

    def executions(self) -> dict:
        """{kernel wrapper: executions of its kernel nodes} in the last graph
        launch (select form: every replay), from the conditional nodes'
        tallies (a host read; the capture must have been made under
        `trace.on`).  The tallies are the graph's, so after a later launch
        of the same graph they hold that launch's.  Empty on the CPU."""
        if self.form == "select":
            return {k: v * self.replays for k, v in self.kernel_nodes.items()}
        if self.device == "cpu":
            return {}
        if self.tallies is None:
            raise ValueError("executions: the graph was captured outside trace.on()")
        counts = self.tallies.cpu().tolist()
        out = collections.Counter(self.root_launches)
        for b in self.bodies:
            evals, true = counts[b.row]
            runs = true if b.taken else evals - true
            for k, v in b.launches.items():
                out[k] += v * runs
        return {k: out[k] for k in self.kernel_nodes}

    def set_condition_evaluations(self) -> int:
        """``set_condition`` executions in the last launch (a host read;
        captured under `trace.on`)."""
        if self.tallies is None:
            raise ValueError("set_condition_evaluations: the graph was captured outside "
                             "trace.on()")
        return int(self.tallies[:, 0].sum())

    def _traced(self):
        if self.recorder is None:
            raise ValueError("the solve ran outside trace.on() or in the select form: it "
                             "recorded no trace")
        return self.recorder

    def phases(self) -> dict:
        """{phase: ms summed over the solve} for each of `trace.PHASES` and
        ``loop``, with ``iterations`` and the ``dropped`` marks
        (`trace.phase_ms`; on the card device time between the marks, a
        host read after the caller has synchronized)."""
        recorder = self._traced()
        return {**trace.phase_ms(recorder.marks()), "dropped": recorder.dropped()}

    def counters(self) -> dict:
        """{counter: total over the solve} of `trace.COUNTERS` (a host read
        after the caller has synchronized)."""
        return self._traced().counters()


LAST_RUN: FusedRun | None = None


def _active(it: torch.Tensor, gnorm: torch.Tensor, max_iters: int, stop: float) -> torch.Tensor:
    """The reference's loop condition (`trajopt_tpu/solver/driver.py:309-311`)."""
    return (it < max_iters) & ((it <= 1) | (gnorm >= stop))


def _live(step: Callable) -> Callable:
    """One counted step: ``(carry, it, gnorm) -> (carry', it + 1, gnorm')``."""

    def live(carry, it, gnorm):
        carry, g = step(carry)
        return carry, it + 1, g.to(gnorm.dtype)

    return live


def _block(step: Callable, max_iters: int, stop: float) -> Callable:
    """``block(carry, it, gnorm) -> (carry, it, gnorm, active)``:
    `STEPS_PER_REPLAY` guarded steps, each ``device_cond(active, step and
    count, nothing)``, so that a step past the stop leaves the carry, ``it``
    and ``gnorm`` as they were, as in the reference's ``while_loop``."""
    live = _live(step)

    def block(carry, it, gnorm):
        for _ in range(STEPS_PER_REPLAY):
            carry, it, gnorm = device_cond(_active(it, gnorm, max_iters, stop), live, _identity,
                                           carry, it, gnorm)
        return carry, it, gnorm, _active(it, gnorm, max_iters, stop)

    return block


def _solve_loop(nodes, step: Callable, carry, max_iters: int, stop: float) -> tuple:
    """The whole loop in the conditional form on ``nodes``: one WHILE over
    the counted step, from iteration 0 and gnorm +inf, between the trace's
    root marks."""
    trace.phase("root")
    out = _while(nodes, lambda c, it, g: _active(it, g, max_iters, stop), _live(step),
                 (carry, *_start(carry)))
    trace.phase("root")
    return out


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
    """A fused solve captured in a CUDA graph.  Conditional form: the whole
    loop, which each `replay` runs from the start state (held in static
    buffers) to its end; ``carry``, ``it`` and ``gnorm`` then hold the
    result.  Select form: one block of `STEPS_PER_REPLAY` steps over static
    buffers, which each replay advances, ``flag`` the loop condition after
    it.  ``inputs`` holds the start state the graph reads, which `load`
    replaces.  The graph also reads everything the step reads (scene,
    constants) at the addresses it was captured with: whoever launches it
    keeps those tensors alive and copies new values into them, as
    `runtime.cache` does."""

    graph: torch.cuda.CUDAGraph
    form: str
    carry: tuple
    it: torch.Tensor
    gnorm: torch.Tensor
    flag: torch.Tensor | None
    run: FusedRun
    inputs: tuple = ()
    launches: int = 0
    max_iters: int = 0

    def load(self, carry) -> None:
        """Copy a new start ``carry`` into the input buffers, on the current
        stream: the next solve starts from it.  Select form: also back to
        iteration 0, gnorm +inf and the flag ``max_iters > 0``."""
        start, it, gnorm = self.inputs
        _tree_map(lambda buf, value: buf.copy_(value), start, carry)
        if self.flag is not None:
            it.zero_()
            gnorm.fill_(float("inf"))
            self.flag.fill_(self.max_iters > 0)

    def replay(self) -> bool:
        """Launch the graph once; True while the loop goes on (select form:
        one host read; conditional form: the loop ran to its end, no read)."""
        self.graph.replay()
        self.launches += 1
        return self.flag is not None and bool(self.flag)


def capture_fn(fn: Callable, device: torch.device, form: str = "conditional",
               warm: Callable | None = None, if_else: bool | None = None, marks: int = 0):
    """``fn()`` captured in one CUDA graph on a side stream of ``device``, in
    ``form`` ("conditional" or "select"), after ``warm()`` (if given) ran
    in the select form on that stream.  ``if_else``: in the conditional
    form, whether an IF node takes an ELSE body (None: where the CUDA
    runtime and driver have it; False: two IF nodes).  ``marks``: the trace
    marks a launch may record (a conditional capture under `trace.on`).
    Returns (the graph, instantiated; what ``fn`` returned; a `FusedRun`
    with no replay yet, its pool's bytes measured across the capture and
    instantiation)."""
    if form not in ("conditional", "select"):
        raise ValueError(f"capture: form is 'conditional' or 'select', got {form!r}")
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    nodes = tallies = recorder = None
    if form == "conditional":
        streams = _body_streams(device)
        if trace.is_on():
            tallies = torch.zeros((MAX_NODES, 2), dtype=torch.int64, device=device)
            recorder = DeviceRecorder(device, marks)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        with trace.timed("trajopt.graph.warmup") as warming:
            if warm is not None:
                with select_form():
                    warm()
        with trace.timed("trajopt.graph.capture") as capturing:
            reserved = torch.cuda.memory_reserved(device)
            pool = torch.cuda.graph_pool_handle()
            g = torch.cuda.CUDAGraph(keep_graph=True)
            before = dict(_cuda.LAUNCHES)
            g.capture_begin(pool=pool)
            try:
                if form == "select":
                    with select_form():
                        result = fn()
                else:
                    if tallies is not None:
                        tallies.zero_()
                        recorder.reset()
                    nodes = CudaNodes(device, pool, streams, tallies, if_else)
                    with conditional_form(nodes), trace.recording(recorder):
                        result = fn()
            finally:
                g.capture_end()
    main.wait_stream(side)
    launched = {name: _cuda.LAUNCHES[name] - before[name] for name in before}
    run = FusedRun("cuda", form, STEPS_PER_REPLAY if form == "select" else None, 0, launched,
                   warming.ms, capturing.ms, 0.0, recorder=recorder)
    if nodes is not None:
        if nodes.root != g.raw_cuda_graph():
            raise RuntimeError("the conditional nodes were built in another graph than the one "
                               "torch captured")
        root = collections.Counter(launched)
        for b in nodes.records:
            root.subtract(b.launches)
        run.cond_nodes, run.versions, run.tallies = dict(nodes.counts), nodes.versions, tallies
        run.bodies, run.root_launches = nodes.records, {k: v for k, v in root.items() if v}
    with trace.timed("trajopt.graph.instantiate") as instantiating:
        g.instantiate()
    run.instantiate_ms = instantiating.ms
    run.pool_bytes = torch.cuda.memory_reserved(device) - reserved
    return g, result, run


def capture(step: Callable, carry, max_iters: int, stop: float,
            form: str = "conditional") -> Captured:
    """Capture the fused loop of ``step`` (see `run_fused`) from ``carry``
    at iteration 0 with gnorm +inf (`capture_fn`): in the conditional form
    the whole loop, in the select form one block.  First one block runs in
    the select form on the capture's stream, so that every op of both sides
    runs once before the capture (kernel builds, K1's shared-memory opt-in,
    cached constants, library handles); its results are dropped."""
    block = _block(step, max_iters, stop)
    static = _tree_map(torch.clone, (carry, *_start(carry)))
    device = static[1].device
    flag = None
    if form == "select":
        flag = torch.full((), max_iters > 0, dtype=torch.bool, device=device)

        def fn():
            *out, out_flag = block(*static)
            _tree_map(lambda s, o: s.copy_(o), static, tuple(out))
            flag.copy_(out_flag)
            return static
    else:
        def fn():
            return _solve_loop(_FORM.get(), step, static[0], max_iters, stop)

    g, (carry, it, gnorm), run = capture_fn(
        fn, device, form, warm=lambda: block(*static),
        marks=trace.MARKS_PER_STEP * max_iters + trace.ROOT_MARKS)
    return Captured(g, form, carry, it, gnorm, flag, run, static, max_iters=max_iters)


def launch(cap: Captured, run: FusedRun) -> FusedRun:
    """Run ``cap``'s solve from its input buffers on the current stream (the
    conditional form's one launch between CUDA events; the select form's
    replays until its flag reads false) and record this call's launches
    and times in ``run``, which it returns."""
    before = cap.launches
    with trace.timed("trajopt.graph.launch") as launching:
        if cap.form == "conditional":
            events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            events[0].record()
            cap.replay()
            events[1].record()
            run.events = events
        else:
            while cap.replay():
                pass
    run.replays = cap.launches - before
    run.host_ms = launching.ms
    return run


def resolve_form(device: torch.device, form: str | None) -> str:
    """`run_fused`'s ``form`` on ``device``: None is "conditional" on the
    card and "branch" on the CPU."""
    form = form or ("conditional" if device.type == "cuda" else "branch")
    if form not in FORMS:
        raise ValueError(f"run_fused: form is one of {FORMS}, got {form!r}")
    return form


def run_fused(step: Callable, carry, max_iters: int, stop: float, form: str | None = None):
    """The fused loop, captured anew at each call on the card (the fused
    drivers keep one capture per key, `runtime.cache`).  ``step(carry) ->
    (carry, gnorm)`` advances
    one iteration; ``carry`` is a tuple of tensors (and NamedTuples of
    them) on one device.  Returns (carry, iterations_run, final_gnorm),
    the last two 0-d tensors on that device, gnorm +inf in the carry's
    dtype until the first step.

    ``form`` (`FORMS`; None: "conditional" on the card, "branch" on the
    CPU): on the card "conditional" captures the whole loop and launches
    the graph once, with no host read; "select" captures one block and
    replays it until its flag reads false (one host read each).  On the
    CPU "branch" and "select" run the same blocks eagerly in that form,
    "conditional" runs the loop on the nodes' stand-in (`EagerNodes`)."""
    global LAST_RUN
    leaf = _leaf(carry)
    form = resolve_form(leaf.device, form)
    if leaf.device.type == "cuda":
        if form == "branch":
            raise ValueError("run_fused: the branch form is the host-stepped drivers' on the card")
        cap = capture(step, carry, max_iters, stop, form)
        LAST_RUN = launch(cap, cap.run)
        return cap.carry, cap.it, cap.gnorm
    recorder = trace.HostRecorder() if trace.is_on() and form != "select" else None
    with trace.timed("trajopt.graph.launch") as running, trace.recording(recorder):
        if form == "conditional":
            nodes = EagerNodes()
            with conditional_form(nodes):
                carry, it, gnorm = _solve_loop(nodes, step, carry, max_iters, stop)
            replays, per_replay = 1, None
        else:
            block = _block(step, max_iters, stop)
            it, gnorm = _start(carry)
            active, replays, per_replay = max_iters > 0, 0, STEPS_PER_REPLAY
            trace.phase("root")
            with select_form() if form == "select" else contextlib.nullcontext():
                while active:
                    carry, it, gnorm, flag = block(carry, it, gnorm)
                    replays += 1
                    active = bool(flag)
            trace.phase("root")
    LAST_RUN = FusedRun("cpu", form, per_replay, replays, {}, 0.0, 0.0, running.ms,
                        recorder=recorder)
    return carry, it, gnorm
