"""The conditional form of the torch port's device control flow
(`runtime.graph`: CUDA IF and WHILE graph nodes whose conditions the
``set_condition`` kernel of `ops.cuda_cond` sets), on the CPU through the
nodes' stand-in `graph.EagerNodes`: the same output buffers, the false
side's copy into them, the loop carry's write-back and the round counter
folded into the predicate, each condition read on the host.  Every step
body of tests/test_torch_fused.py is held bit-equal to the branch form
through it, every `device_cond` / `fixed_rounds` site is driven both ways,
and every fused driver's loop equals the host-stepped solve.  The
``cuda``-marked tests run the nodes themselves on a card
(`chip_smoke.cond_probe`) and skip here."""

import collections
import dataclasses
import os
import re
import sys

import numpy as np
import pytest
import torch

import test_torch_fused as tf
from trajopt_tpu_torch.ops import _cuda, cuda_cond
from trajopt_tpu_torch.runtime import graph
from trajopt_tpu_torch.solver import driver, multi
from trajopt_tpu_torch.ops import splines as sp

torch.set_num_threads(1)
F64 = tf.F64
GRAPH_PY = os.path.basename(graph.__file__)


# ---------------------------------------------------------------------------
# the stand-in, recording each node's condition by site
# ---------------------------------------------------------------------------


def _node_site() -> str:
    """``file:function`` of the code that opened the node: the first frame
    outside `runtime/graph.py` and this file, the fused loop's WHILE named
    as the select form's guard (``graph.py:block``)."""
    frame = sys._getframe(2)
    here = os.path.basename(__file__)
    while True:
        name = os.path.basename(frame.f_code.co_filename)
        if name == GRAPH_PY and frame.f_code.co_name == "_solve_loop":
            return f"{GRAPH_PY}:block"
        if name not in (GRAPH_PY, here):
            return f"{name}:{frame.f_code.co_name}"
        frame = frame.f_back


class RecordingNodes(graph.EagerNodes):
    """`graph.EagerNodes`, recording the value each condition took by site
    into ``seen`` (a WHILE node's site takes each round's value)."""

    def __init__(self, seen):
        self.seen = seen

    def cond(self, pred, then, orelse):
        self.seen[_node_site()].add(bool(pred))
        super().cond(pred, then, orelse)

    def loop(self, cond, body):
        site = _node_site()

        def recorded():
            value = cond()
            self.seen[site].add(bool(value))
            return value

        super().loop(recorded, body)


def _conditional(fn, seen):
    """``fn()`` in the conditional form on the recording stand-in."""
    nodes = RecordingNodes(seen)
    with graph.conditional_form(nodes):
        return fn()


_SEEN = {}


def _ccd_conflict(seen):
    """Both fleet CCDs on two parallel robots moving into each other (the
    setting of tests/test_torch_fused.py's select-form case): uncertified
    pairs, shrink rounds, level 3 live."""
    cfg, consts, scene, _ = tf.fleet_problem(obstacles=False)
    t = np.linspace(0, 1, 3)[:, None]
    wps = [np.array([-3.0, 0, 0]) * (1 - t) + np.array([3.0, 0, 0]) * t]
    wps.append(wps[0] + np.array([0, 0, 0.15]))
    ops = sp.build_spline_ops(2, cfg.res)
    splines = multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64).spline
    directions = torch.zeros_like(splines)
    directions[0, :, 2], directions[1, :, 2] = 0.5, -0.5
    for fn in (multi.coupled_ccd_step, multi.decoupled_ccd_steps):
        want = fn(consts, cfg, splines, directions, scene)
        got = _conditional(lambda: fn(consts, cfg, splines, directions, scene), seen)
        tf._assert_equal_trees(got, want)
        assert float(want.amin()) < 0.2


def _guard(seen):
    """The fused loop as one WHILE on the stand-in, from iteration 0 to a
    cap of 4, against the branch form's blocks."""
    cfg, consts, scene, state = tf.single_problem()
    step = driver.fused_step(consts, cfg, scene)
    want = graph.run_fused(step, (state,), 4, cfg.stop)
    got = _conditional(lambda: graph._solve_loop(graph._FORM.get(), step, (state,), 4, cfg.stop),
                       seen)
    tf._assert_equal_trees(tuple(got), tuple(want))
    assert int(got[1]) == 4


def _conditional_body(name):
    """Run body ``name`` from each of its starts in the branch form and in
    the conditional form; returns the sites seen (cached per process)."""
    if name in _SEEN:
        return _SEEN[name]
    seen = collections.defaultdict(set)
    if name == "ccd_conflict":
        _ccd_conflict(seen)
    elif name == "guard":
        _guard(seen)
    else:
        fn, start, n_steps = tf._bodies()[name]
        for _ in range(n_steps):
            want = tf._step(fn, start)
            got = _conditional(lambda: tf._step(fn, start), seen)
            tf._assert_equal_trees(got, want)
            start = tf._advance(want)
    _SEEN[name] = dict(seen)
    return _SEEN[name]


@pytest.mark.parametrize("body", tf.BODIES)
def test_conditional_form_step_equals_branch_form(body):
    """Each step body of tests/test_torch_fused.py (the ``eigh`` and
    ``ladder`` steps among them) in the conditional form, on the nodes'
    stand-in, equals the branch form's step bit for bit from every start."""
    assert _conditional_body(body)


def test_conditional_form_drives_every_site_both_ways():
    """Across the cases every site of the package's device control flow
    opens its node with the condition true and false: the 13 sites that
    tests/test_torch_fused.py counts."""
    seen = collections.defaultdict(set)
    for body in tf.BODIES:
        for site, values in _conditional_body(body).items():
            seen[site] |= values
    sites = tf._device_cond_sites()
    assert len(sites) == 13, sorted(sites)
    assert {s: seen.get(s, set()) for s in sites} == {s: {False, True} for s in sites}


# ---------------------------------------------------------------------------
# the fused drivers' loop as one WHILE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["single", "coupled", "decoupled", "cached"])
def test_conditional_loop_equals_host_stepped(kind):
    """The fused loop in the conditional form (one WHILE around the step,
    on the stand-in) takes the host-stepped driver's iterations at
    ``max_iters=7`` and ends in a bit-equal state, with one launch."""
    if kind == "single":
        cfg, consts, scene, state0 = tf.single_problem()
        host, hist = driver.solve(consts, cfg, state0, scene, max_iters=7, validate_init=False)
        step, carry = driver.fused_step(consts, cfg, scene), (state0,)
    else:
        options = dict(optimal_plane=True) if kind == "cached" else {}
        cfg, consts, scene, state0 = tf.fleet_problem(**options)
        coupled = kind != "decoupled"
        host, hist = driver.solve_multi(consts, cfg, state0, scene, coupled=coupled, max_iters=7)
        step = driver.fused_step(consts, cfg, scene, coupled, cached=kind == "cached")
        carry = (state0,)
        if kind == "cached":
            carry += (multi.init_multi_caches(cfg, consts, 2, **F64),)
    (state, *_), it, gnorm = graph.run_fused(step, carry, 7, cfg.stop, form="conditional")
    assert int(it) == len(hist) and float(gnorm) == hist[-1]["gnorm"]
    for a, b in zip(state, host):
        assert torch.equal(a, b)
    run = graph.LAST_RUN
    assert (run.form, run.replays, run.steps_per_replay) == ("conditional", 1, None)


@pytest.mark.parametrize("form", graph.FORMS)
def test_every_form_of_the_loop_gives_one_result(form):
    """``run_fused`` on the CPU in each form: the same iterations and bits;
    no step at ``max_iters=0`` (gnorm +inf, the start state)."""
    cfg, consts, scene, state0 = tf.single_problem()
    step = driver.fused_step(consts, cfg, scene)
    want = graph.run_fused(step, (state0,), 5, cfg.stop)
    tf._assert_equal_trees(graph.run_fused(step, (state0,), 5, cfg.stop, form=form), want)
    assert graph.LAST_RUN.form == form
    (state,), it, gnorm = graph.run_fused(step, (state0,), 0, cfg.stop, form=form)
    assert int(it) == 0 and float(gnorm) == float("inf")
    assert all(torch.equal(a, b) for a, b in zip(state, state0))
    with pytest.raises(ValueError, match="form"):
        graph.run_fused(step, (state0,), 5, cfg.stop, form="unrolled")


# ---------------------------------------------------------------------------
# the lowering's buffers
# ---------------------------------------------------------------------------


def _both_forms(fn):
    """(branch form's result, conditional stand-in's result) of ``fn()``."""
    return fn(), _conditional(fn, collections.defaultdict(set))


def test_while_body_returning_aliased_carry_leaves():
    """A body that returns carry leaves in each other's places (the buffers
    swapped, then one as the transposed view of the other) reads every
    leaf before the write-back overwrites it: the stand-in equals the
    branch form, and the caller's carry is left as it was."""
    a = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    b = -torch.arange(6, dtype=torch.float64).reshape(3, 2)
    a0, b0 = a.clone(), b.clone()

    def swap():
        return graph.fixed_rounds(3, lambda x, y: x.sum() < 100.0,
                                  lambda x, y: (y.t() + 1.0, x.t()), a, b)

    def same_place():
        return graph.fixed_rounds(2, lambda x, y: torch.tensor(True),
                                  lambda x, y: (x, y[:, 0].unsqueeze(1).expand(3, 2)), a, b)

    for fn in (swap, same_place):
        want, got = _both_forms(fn)
        tf._assert_equal_trees(tuple(got), tuple(want))
    assert torch.equal(a, a0) and torch.equal(b, b0)


@pytest.mark.parametrize("rounds", [0, 1, 4, 9])
def test_round_counter_is_folded_into_the_predicate(rounds):
    """``fixed_rounds`` stops at ``rounds`` rounds or at the first false
    predicate, whichever comes first, as the branch form does."""
    x = torch.zeros((), dtype=torch.float64)
    fn = lambda: graph.fixed_rounds(rounds, lambda v: v < 5.5, lambda v: (v + 1.0,), x)
    want, got = _both_forms(fn)
    assert float(got[0]) == float(want[0]) == min(rounds, 6)


@pytest.mark.parametrize("pred", [True, False])
def test_if_node_outputs_are_buffers_of_their_own(pred):
    """A true side that returns an operand and a false side that returns a
    view of one: the node's outputs are new buffers (the true side's copy,
    which the false side overwrites), so neither operand is written."""
    x = torch.arange(4, dtype=torch.float64)
    y = torch.arange(8, dtype=torch.float64).reshape(2, 4)
    x0, y0 = x.clone(), y.clone()
    fn = lambda: graph.device_cond(torch.tensor(pred), lambda a, b: (a, b[0]),
                                   lambda a, b: (b[1], a * 2.0), x, y)
    want, got = _both_forms(fn)
    tf._assert_equal_trees(got, want)
    assert all(g.data_ptr() not in (x.data_ptr(), y.data_ptr()) for g in got)
    assert torch.equal(x, x0) and torch.equal(y, y0)


class CapturingNodes(graph.EagerNodes):
    """Runs both bodies of an IF node, the true one first, as a capture
    does (the stand-in runs only the side taken)."""

    def cond(self, pred, then, orelse):
        then()
        orelse()


class CaptureOrderNodes(graph.EagerNodes):
    """Runs every body once, in a capture's order (an IF's true body, then
    its false one; a WHILE's condition, then its body and the condition
    again), and records how deep bodies nest."""

    def __init__(self):
        self.depth = self.deepest = 0

    def _body(self, fn):
        self.depth += 1
        self.deepest = max(self.deepest, self.depth)
        try:
            fn()
        finally:
            self.depth -= 1

    def cond(self, pred, then, orelse):
        self._body(then)
        self._body(orelse)

    def loop(self, cond, body):
        cond()
        self._body(lambda: (body(), cond()))


@pytest.mark.parametrize("body", ["single", "single_ladder", "decoupled_obstacles", "cached",
                                  "grouped_coupled", "batch"])
def test_bodies_nest_within_the_capture_streams(body):
    """A capture nests the step's bodies (the staged ladder's IFs, the
    shrink WHILE and its certify IF) inside the solve's WHILE no deeper
    than the body streams `graph.MAX_DEPTH` it has, one a level."""
    fn, start, _ = tf._bodies()[body]
    single = hasattr(start, "_fields")
    nodes = CaptureOrderNodes()

    def step(*carry):
        new = tf._advance(tf._step(fn, carry[0] if single else carry))
        return (new,) if single else new

    with graph.conditional_form(nodes):
        graph._while(nodes, lambda *c: torch.tensor(True), step, (start,) if single else start)
    assert 3 <= nodes.deepest <= graph.MAX_DEPTH


def test_if_node_sides_must_match():
    """Sides of other shapes or dtypes raise where both are captured, in
    the conditional form as in the select form."""
    for form in (graph.select_form, lambda: graph.conditional_form(CapturingNodes())):
        for pred in (True, False):
            with form(), pytest.raises(ValueError, match="differ"):
                graph.device_cond(torch.tensor(pred), lambda: torch.zeros(3),
                                  lambda: torch.zeros(4))


def test_stand_in_refuses_a_tensor_off_the_cpu():
    with graph.conditional_form(graph.EagerNodes()), pytest.raises(ValueError, match="CPU"):
        graph.device_cond(torch.empty((), dtype=torch.bool, device="meta"), lambda: (),
                          lambda: ())


# ---------------------------------------------------------------------------
# set_condition and the kernel library
# ---------------------------------------------------------------------------


def test_set_condition_plain_version_reads_the_predicate():
    """On a CPU tensor the wrapper is the host read (negated on request)
    and launches nothing; it takes 0-d bool tensors only, and a tensor
    neither on the CPU nor on a card raises instead of taking the plain
    version."""
    before = _cuda.LAUNCHES["set_condition"]
    for value in (True, False):
        assert cuda_cond.set_condition(0, torch.tensor(value)) is value
        assert cuda_cond.set_condition(0, torch.tensor(value), negate=True) is (not value)
    assert _cuda.LAUNCHES["set_condition"] == before
    for bad in (torch.tensor(1), torch.tensor([True])):
        with pytest.raises(ValueError, match="0-d bool"):
            cuda_cond.set_condition(0, bad)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cond.set_condition(0, torch.empty((), dtype=torch.bool, device="meta"))


def test_graph_cond_source_is_built_and_bound():
    """``csrc/graph_cond.cu`` is in the build, every C entry point it
    defines has a ctypes signature, and ``set_condition`` is counted."""
    assert "graph_cond.cu" in _cuda.SOURCES
    text = (_cuda.CSRC / "graph_cond.cu").read_text()
    defined = set(re.findall(r'extern "C" int (\w+)\(', text))
    assert defined == {n for n in _cuda._SIGNATURES if n in text}
    assert defined <= set(_cuda._SIGNATURES)
    assert "set_condition" in _cuda.LAUNCHES


def test_executions_from_tallies():
    """`FusedRun.executions`: root kernels once a launch; a WHILE body as
    often as its condition was set true, an IF body as often as it was
    taken, an ELSE body as often as it was not."""
    body = graph._Body
    run = graph.FusedRun(
        "cuda", "conditional", None, 1, {"k": 9, "set_condition": 4, "other": 0}, 0.0, 0.0, 0.0,
        tallies=torch.tensor([[8, 7], [7, 2], [7, 5]]),
        bodies=[body(0, True, collections.Counter(k=2, set_condition=1)),
                body(1, True, collections.Counter(k=3)),
                body(1, False, collections.Counter(k=1)),
                body(2, True, collections.Counter(set_condition=1))],
        root_launches={"k": 1, "set_condition": 1})
    assert run.executions() == {"k": 1 + 2 * 7 + 3 * 2 + 1 * 5, "set_condition": 1 + 7 + 5,
                                "other": 0}
    assert run.set_condition_evaluations() == 22
    select = dataclasses.replace(run, form="select", replays=3)
    assert select.executions() == {"k": 27, "set_condition": 12, "other": 0}


def test_nodes_route_every_threads_allocations_to_the_graph_pool(monkeypatch):
    """`graph.CudaNodes` replaces torch's routing of the capture's
    allocations (by the stream's capture id) with one of every allocation
    on the device, from any thread: the autograd engine allocates the
    step's backward passes on a thread of its own, and a routing of the
    capturing thread alone left those blocks in the shared pool, which
    handed them out again while the graph still used them (an illegal
    address on the card after `torch.cuda.empty_cache`).  The routing adds
    no use of the pool: torch's capture_end ends it and the graph's reset
    releases the pool once."""
    calls = []
    for name in ("_cuda_endAllocateToPool", "_cuda_beginAllocateToPool",
                 "_cuda_beginAllocateCurrentThreadToPool", "_cuda_releasePool"):
        monkeypatch.setattr(torch._C, name, lambda *a, _name=name: calls.append((_name, a)),
                            raising=False)
    monkeypatch.setattr(cuda_cond, "versions", lambda: (12090, 13000))
    pool = (0, 7)
    graph.CudaNodes(torch.device("cuda", 0), pool, [], None)
    assert calls == [("_cuda_endAllocateToPool", (0, pool)),
                     ("_cuda_beginAllocateToPool", (0, pool)),
                     ("_cuda_releasePool", (0, pool))]


# ---------------------------------------------------------------------------
# the sharded drivers' form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device,world,want", [("cuda", 2, "select"), ("cuda", 4, "select"),
                                               ("cuda", 1, None), ("cpu", 2, None)])
def test_fused_form_is_select_only_across_ranks_on_the_card(monkeypatch, device, world, want):
    """`driver.fused_form`: the select form for robots sharded over more
    than one process on the card (NCCL's collectives inside conditional
    bodies are proven only at world size 1), else run_fused's default."""
    group = object()
    monkeypatch.setattr(driver.dist, "get_world_size", lambda g: world if g is group else -1)
    assert driver.fused_form(torch.device(device), group) == want
    assert driver.fused_form(torch.device(device), None) is None


@pytest.mark.parametrize("cached", [False, True])
def test_sharded_fused_drivers_pass_the_form(monkeypatch, cached):
    """`solve_fused_multi` and `solve_fused_multi_cached` hand the graph
    cache (`runtime.cache.run`, which runs `graph.run_fused`'s forms) the
    form `driver.fused_form` picks for their state and group."""
    group, seen = object(), []
    state = type("State", (), {"spline": torch.zeros(1)})()
    monkeypatch.setattr(driver, "fused_form",
                        lambda device, axis: "select" if axis is group else None)
    monkeypatch.setattr(driver.dist, "get_world_size", lambda g: 2)

    def fake_run(static, make_step, consts, scene, carry, max_iters, stop, form=None):
        seen.append(form)
        return carry, torch.tensor(0), torch.tensor(0.0)

    monkeypatch.setattr(driver.cache, "run", fake_run)
    cfg = driver.TrajOptConfig()
    for axis in (group, None):
        if cached:
            driver.solve_fused_multi_cached(None, cfg, state, None, True, ((), ()),
                                            axis_name=axis)
        else:
            driver.solve_fused_multi(None, cfg, state, None, True, axis_name=axis)
    assert seen == ["select", None]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python3 chip_smoke.py)")
    import chip_smoke

    chip_smoke.cond_probe(torch.device("cuda"), lambda s: None, cases=(case,))


@pytest.mark.cuda
def test_if_node_on_card():
    """An IF node, true and false, against the host branch."""
    _on_card("if")


@pytest.mark.cuda
def test_if_else_node_on_card():
    """An IF/ELSE (two IF nodes before CUDA 12.8) against the host branch."""
    _on_card("if_else")


@pytest.mark.cuda
def test_while_node_on_card():
    """A WHILE node counting to N, and one of 0 trips."""
    _on_card("while")


@pytest.mark.cuda
def test_conditional_graph_owns_its_memory_on_card():
    """A fused batch solve captured in the conditional form and launched
    after `torch.cuda.empty_cache` and a NaN fill of the free memory, four
    times (two captures), bit-equal to the select form's solve each time
    (`tools/cond_fault_check.py`'s "batch-stress")."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python tools/cond_fault_check.py)")
    sys.path.insert(0, str(_cuda._PKG.parent / "tools"))
    import cond_fault_check

    report = cond_fault_check.run_case("batch-stress", 4)
    assert report["fault"] is None and not report["mismatch"], report


@pytest.mark.cuda
def test_nested_nodes_on_card():
    """A WHILE in a WHILE with an IF in it (three levels, as the decoupled
    solve nests them) against the host loops."""
    _on_card("nested")
