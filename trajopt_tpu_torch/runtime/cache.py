"""The fused drivers' graph cache: one captured solve per key, launched again.

Counterpart of `trajopt_tpu/runtime/cache.py` and of the in-memory
executable cache of ``jax.jit``.  The JAX fused drivers are ``jax.jit``
functions (`trajopt_tpu/solver/driver.py:296`, `:324-330`, `:368-371`;
the batch drivers go through the second): a second call with new values of
the same shapes runs the executable the first compiled.  Here a second
fused call with the same key launches the CUDA graph the first captured
(`graph.capture`), with no warm-up and no capture.

- **Key**: what ``jax.jit`` treats as static, and shapes.  The driver's
  static arguments (the step kind, ``cfg`` with its ``stop``, ``coupled``,
  ``interact``, ``groups``, the process group ``axis_name`` by identity
  and its world size), ``max_iters``, the form the loop runs in
  (`graph.resolve_form`), whether tracing is on (`trace.on`: a graph
  captured without it holds no marks, counters or tallies, and one
  captured with it launches their kernels), and the shape, dtype and device of every tensor
  leaf of the constants, the scene and the start carry.  Never a value.
- **An entry owns its inputs.**  On a miss it copies the constants, the
  scene and the carry into buffers of its own and builds the step over
  them; on every call it copies the caller's values into them, on the
  current stream, before the launch.  So a new start, scene or constants
  are read by value, and a graph never reads an address it does not own.
- **Results never alias the graph**: each call returns clones of the
  carry, the iterations and gnorm, as ``jax.jit`` returns fresh arrays.
- **Bounded.**  A graph's private pool holds its intermediates, where an
  XLA executable holds none, so the cache keeps at most `MAX_ENTRIES`
  entries in least-recently-used order and `clear` drops them all.  On an
  H100 the conditional graphs' pools measured 61 MB (bridge P=4) to 803
  MB (64-robot cross coupled with ``optimal_plane``), and 6.5 GB for a
  batch of 1024 bridge scenarios (`chip_smoke.py` phases 6-8,
  `FusedRun.pool_bytes`; PERF.md, section 5).  8 entries of the single
  solves and fleets hold at most 6.4 GB, 8% of the card's 80 GB, and 8
  keys cover a caller that alternates a few problem shapes and iteration
  caps; a caller of many batch shapes that large calls `clear`.
- **No disk half.**  `trajopt_tpu/runtime/cache.py` keeps XLA's compiles
  on disk across processes.  A CUDA graph holds the device addresses of
  one process and cannot be serialised; what does persist, the kernels'
  build, is cached on disk in `trajopt_tpu_torch/_build/` (`ops/_cuda.py`).

A call's host work is traced (`runtime.trace`) as the spans
``trajopt.cache.key``, ``trajopt.cache.load`` and ``trajopt.cache.clone``
around the key, the copies in and the clones out.

On the CPU an entry runs the loop eagerly (`graph.run_fused` in the form
the key names) over its own buffers, so the key, the copies, the clones,
the order and `clear` are the card's.  Nothing gives way quietly: another
key captures again, and a capture or launch that fails raises.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from . import graph, trace

# Entries kept, least recently used dropped first (see the docstring).
MAX_ENTRIES = 8

_ENTRIES: collections.OrderedDict = collections.OrderedDict()


def _signature(tree):
    """The container types and every tensor leaf's shape, dtype and device."""
    if isinstance(tree, tuple):
        return type(tree).__name__, tuple(_signature(part) for part in tree)
    if not torch.is_tensor(tree):
        raise TypeError("graph cache: a fused solve takes tensors, tuples and NamedTuples of "
                        f"them, got {type(tree).__name__}")
    return tuple(tree.shape), tree.dtype, tree.device


def _own(tree):
    return graph._tree_map(lambda x: x.clone(memory_format=torch.contiguous_format), tree)


def _load(buffers, values) -> None:
    graph._tree_map(lambda buf, value: buf.copy_(value), buffers, values)


@dataclasses.dataclass
class _Entry:
    """A solve's own constants and scene, the step over them, and on the
    card its captured solve (`graph.Captured`, which holds the start carry)
    or on the CPU the start carry."""

    consts: tuple
    scene: tuple
    step: Callable
    max_iters: int
    stop: float
    form: str
    carry: tuple | None = None
    cap: graph.Captured | None = None

    def solve(self, consts, scene, carry, hit: bool):
        """Load the caller's values, run the solve, return clones of its
        (carry, iterations, gnorm); sets `graph.LAST_RUN`."""
        with trace.span("trajopt.cache.load"):
            _load(self.consts, consts)
            _load(self.scene, scene)
            if self.cap is None:
                _load(self.carry, carry)
            else:
                self.cap.load(carry)
        if self.cap is None:
            out = graph.run_fused(self.step, self.carry, self.max_iters, self.stop, self.form)
            graph.LAST_RUN.hit = hit
        else:
            run = self.cap.run
            if hit:
                run = dataclasses.replace(run, hit=True, warmup_ms=0.0, capture_ms=0.0,
                                          instantiate_ms=0.0)
            graph.LAST_RUN = graph.launch(self.cap, run)
            out = self.cap.carry, self.cap.it, self.cap.gnorm
        with trace.span("trajopt.cache.clone"):
            return graph._tree_map(torch.clone, out)


def run(static: tuple, make_step: Callable, consts, scene, carry, max_iters: int, stop: float,
        form: str | None = None):
    """The fused loop of ``make_step(consts, scene)`` (a `driver.fused_step`)
    from ``carry``, as `graph.run_fused` runs it, through the cache.
    ``static``: the driver's static arguments, hashable (see the module
    docstring); ``stop`` is ``static``'s ``cfg.stop``.  Returns (carry,
    iterations_run, final_gnorm), fresh tensors."""
    with trace.span("trajopt.cache.key"):
        device = graph._leaf(carry).device
        form = graph.resolve_form(device, form)
        key = (static, max_iters, form, trace.is_on(), device, _signature(consts),
               _signature(scene), _signature(carry))
        entry = _ENTRIES.get(key)
    if entry is not None:
        _ENTRIES.move_to_end(key)
        return entry.solve(consts, scene, carry, hit=True)
    own_consts, own_scene = _own(consts), _own(scene)
    entry = _Entry(own_consts, own_scene, make_step(own_consts, own_scene), max_iters, stop, form)
    if device.type == "cuda":
        entry.cap = graph.capture(entry.step, _own(carry), max_iters, stop, form)
    else:
        entry.carry = _own(carry)
    out = entry.solve(consts, scene, carry, hit=False)
    _ENTRIES[key] = entry
    while len(_ENTRIES) > MAX_ENTRIES:
        _ENTRIES.popitem(last=False)
    return out


def size() -> int:
    """Entries held."""
    return len(_ENTRIES)


def clear() -> None:
    """Drop every entry: its graph, pool and buffers."""
    _ENTRIES.clear()
