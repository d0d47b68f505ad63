"""Tracing from inside the program: host spans, device marks between the
phases of the step, and per-iteration work counters.

One switch, `on()`, off by default.  Outside it nothing is recorded and
each call below costs one check.  Inside it:

- **Host spans** (`span`, `timed`, `traced`): ``(name, start_ns, end_ns,
  id, parent, request)`` on the host's ``perf_counter_ns`` clock, kept in a
  bounded buffer that `drain` empties.  A span carries the id of the span
  open around it and the request `request` opened around it (a span
  outside any request, and its children, get an id of their own).  While a
  ``torch.profiler`` session records, a span also enters
  ``torch.profiler.record_function`` under its name, so that it lies on the
  profiler's clock beside the device's kernel records.  Outside the switch
  it does not: a profile taken with tracing off holds what it held before
  the spans existed.
- **Marks** (`phase`): the step marks the start of each of its `PHASES`
  and its end; the fused loop marks the graph's root before and after its
  WHILE node.  Inside a capture in the conditional form each mark is a
  one-thread kernel node (``csrc/graph_cond.cu``) that writes its id and
  the card's ``%globaltimer`` into a buffer the capture owns
  (`runtime.graph`); on the CPU, in the branch form and on the nodes'
  stand-in, a mark reads ``perf_counter_ns``.  The time from one mark to
  the next belongs to the earlier mark's phase, or to ``loop`` after a
  step's end and the root marks (`phase_ms`).
- **Counters** (`count`): a value added to one of `COUNTERS` per
  iteration, on the card into the capture's buffer.

The select form records no mark and no count: both sides of every
`graph.device_cond` run there, so neither would describe the work that
was taken.  `timed` spans always read the clock (`graph.FusedRun` takes
its warm-up, capture, instantiation and host times from them) and are
recorded only under the switch.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import time
from typing import Callable, NamedTuple

import torch

PHASES = ("planes", "direction", "ccd", "armijo", "slack", "diag")
LOOP = "loop"
# A mark's id: a phase's start (its index in PHASES), a step's end, the root.
MARK_IDS = {**{name: i for i, name in enumerate(PHASES)}, "end": len(PHASES),
            "root": len(PHASES) + 1}
MARKS_PER_STEP = len(PHASES) + 1
ROOT_MARKS = 2
COUNTERS = ("planes", "ccd_live_segments", "armijo_trials", "slack_rungs", "direction_fallbacks")
# Host spans kept until `drain`; later ones are dropped and counted.
MAX_SPANS = 1 << 16

_ON = contextvars.ContextVar("trajopt_trace_on", default=False)
# Where `phase` and `count` go: a recorder, or None (nothing recorded).
_RECORDER = contextvars.ContextVar("trajopt_trace_recorder", default=None)
_PARENT = contextvars.ContextVar("trajopt_trace_parent", default=None)
_REQUEST = contextvars.ContextVar("trajopt_trace_request", default=None)
_IDS = itertools.count(1)
_SPANS: list = []
_DROPPED = 0


class Span(NamedTuple):
    """A closed host span; ``parent`` is None at the top of a request."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    request: int


class HostRecorder:
    """Marks on the host's clock and counters summed as they come (a
    tensor value stays on its device until `counters` reads it)."""

    def __init__(self):
        self._marks: list = []
        self._totals: dict = {}

    def mark(self, mark_id: int) -> None:
        self._marks.append((mark_id, time.perf_counter_ns()))

    def count(self, name: str, value) -> None:
        self._totals[name] = self._totals.get(name, 0) + value

    def marks(self) -> list:
        """[(mark id, ns)] in the order they were made."""
        return list(self._marks)

    def dropped(self) -> int:
        return 0

    def counters(self) -> dict:
        return {name: int(self._totals.get(name, 0)) for name in COUNTERS}


@contextlib.contextmanager
def on():
    """The tracing switch.  Inside the block spans, marks and counts are
    recorded, and a fused solve's capture holds the marks' and counters'
    kernels (a graph captured inside and one captured outside are two
    entries of `runtime.cache`; a capture inside also keeps the tallies of
    `graph.FusedRun.executions`).  Yields the recorder of what runs outside
    any fused solve (the host-stepped drivers: the branch form)."""
    recorder = HostRecorder()
    on_token, rec_token = _ON.set(True), _RECORDER.set(recorder)
    try:
        yield recorder
    finally:
        _RECORDER.reset(rec_token)
        _ON.reset(on_token)


def is_on() -> bool:
    """Whether tracing is switched on here (inside `on`)."""
    return _ON.get()


@contextlib.contextmanager
def recording(recorder):
    """Send `phase` and `count` inside the block to ``recorder`` (None:
    record nothing)."""
    token = _RECORDER.set(recorder)
    try:
        yield
    finally:
        _RECORDER.reset(token)


def phase(name: str) -> None:
    """Mark the start of the step's phase ``name`` (`PHASES`), the step's
    end ("end") or the graph's root ("root")."""
    recorder = _RECORDER.get()
    if recorder is not None:
        recorder.mark(MARK_IDS[name])


def count(name: str, value: Callable | torch.Tensor | int) -> None:
    """Add ``value`` (a 0-d tensor or an int, or a callable that returns
    one, called only while recording) to the counter ``name`` (`COUNTERS`)."""
    recorder = _RECORDER.get()
    if recorder is not None:
        recorder.count(name, value() if callable(value) else value)


def phase_ms(marks: list) -> dict:
    """{phase: ms} over ``marks`` [(mark id, ns)], with `LOOP` and the
    ``iterations`` (steps ended): each interval between two marks belongs to
    the earlier mark's phase, or to `LOOP` after a step's end or a root
    mark, so that the phases tile the time from the first mark to the last."""
    out = dict.fromkeys(PHASES + (LOOP,), 0.0)
    for (mark_id, t0), (_, t1) in zip(marks, marks[1:]):
        out[PHASES[mark_id] if mark_id < len(PHASES) else LOOP] += (t1 - t0) * 1e-6
    out["iterations"] = sum(1 for mark_id, _ in marks if mark_id == MARK_IDS["end"])
    return out


# The span outside the switch: records nothing.
_NULL = contextlib.nullcontext()


class _Open:
    """A span while it is open; after it closes, ``ms`` is its length."""

    __slots__ = ("name", "record", "start_ns", "end_ns", "id", "parent", "request", "_tokens",
                 "_profiled")

    def __init__(self, name: str, record: bool):
        self.name, self.record = name, record
        self._profiled = None

    def __enter__(self):
        if self.record:
            self.id, self.parent = next(_IDS), _PARENT.get()
            self.request = _REQUEST.get()
            if self.request is None:
                self.request = next(_IDS)
            self._tokens = _PARENT.set(self.id), _REQUEST.set(self.request)
            if torch.autograd._profiler_enabled():
                self._profiled = torch.profiler.record_function(self.name)
                self._profiled.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _DROPPED
        self.end_ns = time.perf_counter_ns()
        if self.record:
            if self._profiled is not None:
                self._profiled.__exit__(*exc)
            _PARENT.reset(self._tokens[0])
            _REQUEST.reset(self._tokens[1])
            if len(_SPANS) < MAX_SPANS:
                _SPANS.append(Span(self.name, self.start_ns, self.end_ns, self.id, self.parent,
                                   self.request))
            else:
                _DROPPED += 1
        return False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def span(name: str):
    """A host span ``name`` (recorded only inside `on`)."""
    return _Open(name, True) if _ON.get() else _NULL


def timed(name: str) -> _Open:
    """A host span that always reads the clock (its ``ms`` after the
    block), recorded only inside `on`."""
    return _Open(name, _ON.get())


def traced(name: str):
    """Decorator: each call of the function is a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON.get():
                return fn(*args, **kwargs)
            with _Open(name, True):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def request():
    """Every span inside the block carries one new request id (one plan)."""
    token = _REQUEST.set(next(_IDS))
    try:
        yield
    finally:
        _REQUEST.reset(token)


def drain() -> list:
    """The host spans recorded since the last call, in the order they
    closed, and empty the buffer."""
    global _SPANS, _DROPPED
    out, _SPANS, _DROPPED = _SPANS, [], 0
    return out


def dropped() -> int:
    """Spans dropped since the last `drain` because the buffer was full."""
    return _DROPPED


def self_ns(spans: list) -> dict:
    """{span id: its length less its children's}."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
