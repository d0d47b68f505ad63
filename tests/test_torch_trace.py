"""Tracing from inside the program (`trajopt_tpu_torch/runtime/trace.py`):
the step's phase marks and work counters in each form of the fused loop,
the host spans of the drivers and the graph cache, and the switch that
turns them on.  On the CPU in float64; the ``cuda``-marked test holds the
mark kernel to its contract on a card and skips here.  The file imports no
JAX, so that on a card machine ``python -m pytest --noconftest -m cuda
tests/test_torch_trace.py`` runs it."""

import contextlib
import dataclasses
import importlib
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import testing
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import splines as sp
from trajopt_tpu_torch.runtime import cache, graph, trace
from trajopt_tpu_torch.scenes import generators as gen
from trajopt_tpu_torch.solver import admm, driver, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
ITERS = 5
WAYPOINTS = np.array([[-3.0, 0.0, 0.0], [-1.0, 1.7, 0.0], [1.0, 1.7, 0.0], [3.0, 0.0, 0.0]])
STEP = [trace.MARK_IDS[p] for p in trace.PHASES] + [trace.MARK_IDS["end"]]
ROOT = trace.MARK_IDS["root"]
CHECKOUT = Path(__file__).resolve().parent.parent


def single_problem(device="cpu", dtype=torch.float64):
    """One UAV, 3 pieces at res 2, passing 0.15 from a sphere of 200
    points, so that every iteration has planes."""
    kw = dict(device=device, dtype=dtype)
    cfg = tconfig.TrajOptConfig(res=2, max_planes=8, max_ccd_candidates=8)
    ops = sp.build_spline_ops(len(WAYPOINTS) - 1, cfg.res)
    cloud = gen.sphere_scene(n_points=200, radius=0.3, center=(0.0, 1.25, 0.0), seed=1)
    return (cfg, tt.device_consts(ops, **kw), tt.make_scene(cloud, **kw),
            tt.init_state(ops, WAYPOINTS, cfg.init_piece_time, **kw))


def fleet_problem():
    """Two robots crossing at right angles 0.15 apart vertically, near a
    sphere of 200 points (tests/test_torch_fused.py's fleet)."""
    cfg = tconfig.TrajOptConfig(res=2, max_planes=4, max_self_planes=2, max_ccd_candidates=4,
                                ks=1e-3)
    t = np.linspace(0, 1, 3)[:, None]
    wps = [np.array([-3.0, 0, 0]) * (1 - t) + np.array([3.0, 0, 0]) * t,
           np.array([0, -3.0, 0.15]) * (1 - t) + np.array([0, 3.0, 0.15]) * t]
    ops = sp.build_spline_ops(2, cfg.res)
    cloud = gen.sphere_scene(200, radius=0.3, center=(1.5, 0.42, 0.0))
    return (cfg, tt.device_consts(ops, **F64), tt.make_scene(cloud, **F64),
            multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64))


@pytest.fixture(autouse=True)
def _fresh():
    cache.clear()
    trace.drain()
    yield
    cache.clear()
    trace.drain()


def _ids(recorder) -> list:
    return [mark_id for mark_id, _ in recorder.marks()]


def _assert_equal_trees(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# marks and counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["branch", "conditional"])
def test_fused_solve_marks_its_phases_in_order(form):
    """A fused single-UAV solve (the CPU's branch form through the drivers'
    cache, and the nodes' stand-in) marks the root, then each iteration's
    six phases and its end, then the root again: every interval belongs to
    a phase, each iteration's loop interval included, and the phases tile
    the time from the first mark to the last."""
    cfg, consts, scene, state0 = single_problem()
    with trace.on():
        if form == "branch":
            driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
        else:
            graph.run_fused(driver.fused_step(consts, cfg, scene), (state0,), ITERS, cfg.stop,
                            form=form)
    run = graph.LAST_RUN
    assert run.form == form
    marks = run.recorder.marks()
    assert [m for m, _ in marks] == [ROOT] + STEP * ITERS + [ROOT]
    assert all(t0 <= t1 for (_, t0), (_, t1) in zip(marks, marks[1:]))
    phases = run.phases()
    assert phases["iterations"] == ITERS and phases["dropped"] == 0
    assert all(phases[p] > 0 for p in trace.PHASES + (trace.LOOP,))
    total = sum(phases[p] for p in trace.PHASES + (trace.LOOP,))
    assert total == pytest.approx((marks[-1][1] - marks[0][1]) * 1e-6, rel=1e-12)


def test_host_stepped_and_eager_nodes_agree():
    """The host-stepped `driver.solve` (branch form, recorded by the
    switch's own recorder) and the fused loop on the nodes' stand-in mark
    the same phases per iteration and count the same work; the planes
    counted are the history's."""
    cfg, consts, scene, state0 = single_problem()
    with trace.on() as host:
        _, history = driver.solve(consts, cfg, state0, scene, max_iters=ITERS)
        graph.run_fused(driver.fused_step(consts, cfg, scene), (state0,), ITERS, cfg.stop,
                        form="conditional")
    fused = graph.LAST_RUN.recorder
    assert _ids(host) == STEP * len(history)
    assert [m for m in _ids(fused) if m != ROOT] == _ids(host)
    assert fused.counters() == host.counters()
    counts = host.counters()
    assert counts["planes"] == sum(h["n_planes"] for h in history) > 0
    assert counts["armijo_trials"] >= 2 * len(history)
    assert counts["ccd_live_segments"] > 0


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
def test_fleet_step_marks_the_same_six_phases(coupled):
    """A fleet's fused solve marks the single-UAV step's six phases in the
    same order each iteration, and counts its planes (the history's) and
    its trial energies."""
    cfg, consts, scene, state0 = fleet_problem()
    iters = 3
    with trace.on() as host:
        _, history = driver.solve_multi(consts, cfg, state0, scene, coupled, max_iters=iters)
        driver.solve_fused_multi(consts, cfg, state0, scene, coupled, max_iters=iters)
    run = graph.LAST_RUN
    assert _ids(run.recorder) == [ROOT] + STEP * iters + [ROOT]
    assert _ids(host) == STEP * iters
    assert all(run.phases()[p] > 0 for p in trace.PHASES)
    counts = run.counters()
    assert counts == host.counters()
    assert counts["planes"] == sum(h["n_planes"] for h in history) > 0
    assert counts["armijo_trials"] >= (2 if coupled else 1) * iters


def test_phase_ms_gives_each_interval_to_the_earlier_mark():
    """`trace.phase_ms` on hand-made marks: a phase's interval runs to the
    next mark, and after a step's end or a root mark time is the loop's."""
    ms = 1_000_000
    ids = [ROOT] + STEP + STEP + [ROOT]
    times = [0, 1, 3, 6, 10, 15, 21, 28, 30, 31, 32, 33, 34, 35, 36, 40]
    got = trace.phase_ms([(m, t * ms) for m, t in zip(ids, times)])
    assert got == {"planes": 2.0 + 1.0, "direction": 3.0 + 1.0, "ccd": 4.0 + 1.0,
                   "armijo": 5.0 + 1.0, "slack": 6.0 + 1.0, "diag": 7.0 + 1.0,
                   "loop": 1.0 + 2.0 + 4.0, "iterations": 2}


def test_device_recorder_buffer_and_plain_mark():
    """A capture's buffer (`graph.DeviceRecorder`) on the CPU, where each
    mark takes the kernel's plain version: marks in order up to the
    capacity, the rest dropped and counted, counters summed by name, and
    `reset` back to no mark and zero counts."""
    rec = graph.DeviceRecorder(torch.device("cpu"), 3)
    for name in ("planes", "direction", "ccd", "armijo", "end"):
        rec.mark(trace.MARK_IDS[name])
    rec.count("planes", torch.tensor(4))
    rec.count("planes", torch.tensor(True).sum())
    rec.count("armijo_trials", 8)
    rec.count("slack_rungs", torch.tensor([0, 2, 1], dtype=torch.int32).sum())
    assert [m for m, _ in rec.marks()] == [0, 1, 2]
    assert rec.dropped() == 2
    assert rec.counters() == {"planes": 5, "ccd_live_segments": 0, "armijo_trials": 8,
                              "slack_rungs": 3}
    rec.reset()
    assert rec.marks() == [] and rec.dropped() == 0
    assert set(rec.counters().values()) == {0}
    with pytest.raises(ValueError, match="int64"):
        graph.cuda_cond.mark(torch.zeros((2, 2)), torch.zeros(1, dtype=torch.int64), 0)


def _benchmark_module(name: str):
    """A module of the benchmark's folder (``reference.admm``, the
    ``tools/`` scripts' ``harness``), imported as ``benchmark/run.py``
    imports them: with the folder on the path."""
    if str(CHECKOUT / "benchmark") not in sys.path:
        sys.path.insert(0, str(CHECKOUT / "benchmark"))
    return importlib.import_module(name)


@pytest.mark.parametrize("case", testing.SLACK_CASES, ids=[c[0] for c in testing.SLACK_CASES])
def test_slack_update_is_the_frozen_reference_with_its_rungs_counted(case):
    """On the CPU in float64 `admm.slack_update` (the plain version) is bit
    for bit the benchmark's frozen `reference/admm.py::slack_update` with
    the switch on, and the ``slack_rungs`` counter is the sum of every
    piece's accepted rung index there."""
    ref_admm = _benchmark_module("reference.admm")
    consts, cfg, state = testing.slack_case(*case[1:])
    with trace.on() as rec:
        got, res = admm.slack_update(consts, cfg, state)
    want, want_res, rungs = testing.slack_with_rungs(ref_admm.slack_update, consts, cfg, state)
    for a, b in zip(tuple(got) + (res,), tuple(want) + (want_res,), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert rec.counters()["slack_rungs"] == int(rungs.sum())


def test_trace_report_reports_slack_rungs_and_one_cloud_counts_the_same():
    """`tools/trace_report.py`'s stretch and summary on a stand-in planner
    (fused CPU solves of this file's problem): every counter of
    `trace.COUNTERS`, ``slack_rungs`` among them, is reported an iteration,
    and two plans of one cloud count the same."""
    spec = importlib.util.spec_from_file_location("trace_report",
                                                  CHECKOUT / "tools" / "trace_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    cfg, consts, scene, state0 = single_problem()

    class Planner:
        def plan(self, req):
            _, it, _ = driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
            run = graph.LAST_RUN
            return types.SimpleNamespace(index=req.index, iterations=int(it), hit=run.hit,
                                         launch_ms=run.replay_ms, latency_ms=2 * run.replay_ms)

    pool = [types.SimpleNamespace(index=i) for i in (0, 1, 0)]
    stretches = [report.stretch(Planner(), pool, pool[:1], "cpu", on) for on in (False, True)]
    summary = report.summary(stretches)
    assert set(summary["counters_per_iter"]) == set(trace.COUNTERS)
    assert "slack_rungs" in trace.COUNTERS
    assert summary["same_cloud_same_counters"]
    first, _, again = stretches[1]["traced"]
    assert first["counters"] == again["counters"]
    assert first["counters"]["slack_rungs"] >= 0


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["single", "coupled"])
def test_outputs_are_bit_equal_with_the_switch_on_and_off(kind):
    """Marks and counters change no result."""
    if kind == "single":
        cfg, consts, scene, state0 = single_problem()
        solve = lambda: driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
    else:
        cfg, consts, scene, state0 = fleet_problem()
        solve = lambda: driver.solve_fused_multi(consts, cfg, state0, scene, True, max_iters=3)
    off = solve()
    with trace.on():
        on = solve()
    _assert_equal_trees(on, off)


def test_switch_on_and_off_are_two_cache_entries():
    """A solve inside the switch misses beside the same solve outside it,
    and each hits its own entry after."""
    cfg, consts, scene, state0 = single_problem()
    solve = lambda: driver.solve_fused(consts, cfg, state0, scene, max_iters=2)
    solve()
    with trace.on():
        solve()
        assert not graph.LAST_RUN.hit and cache.size() == 2
        solve()
        assert graph.LAST_RUN.hit and graph.LAST_RUN.recorder is not None
    solve()
    assert graph.LAST_RUN.hit and graph.LAST_RUN.recorder is None and cache.size() == 2


def test_switch_off_records_nothing():
    """Outside the switch no span, mark or count is recorded, and a run's
    phases and counters refuse to answer."""
    cfg, consts, scene, state0 = single_problem()
    assert not trace.is_on()
    driver.solve_fused(consts, cfg, state0, scene, max_iters=2)
    driver.solve(consts, cfg, state0, scene, max_iters=2)
    assert trace.drain() == [] and trace.dropped() == 0
    run = graph.LAST_RUN
    assert run.recorder is None
    for read in (run.phases, run.counters):
        with pytest.raises(ValueError, match="outside trace.on"):
            read()


def test_select_form_records_nothing():
    """In the select form both sides of every branch run, so it records no
    mark and no count, in the fused run or in the switch's recorder."""
    cfg, consts, scene, state0 = single_problem()
    with trace.on() as host:
        graph.run_fused(driver.fused_step(consts, cfg, scene), (state0,), 2, cfg.stop,
                        form="select")
    assert graph.LAST_RUN.recorder is None
    assert host.marks() == [] and set(host.counters().values()) == {0}


# ---------------------------------------------------------------------------
# host spans
# ---------------------------------------------------------------------------


def test_spans_nest_within_their_parent_and_request():
    """One plan inside `trace.request`: the inputs and the solve are its
    top-level spans, the cache's key, load and clone and the loop's run
    are the solve's children, inside it; each carries its parent's id and
    the request's; self time is the length less the children's.  A span
    outside any request gets a request id of its own."""
    cfg, consts, _, _ = single_problem()
    ops = sp.build_spline_ops(len(WAYPOINTS) - 1, cfg.res)
    cloud = gen.sphere_scene(n_points=200, radius=0.3, center=(0.0, 1.25, 0.0), seed=1)
    with trace.on():
        with trace.request():
            scene = tt.make_scene(cloud, **F64)
            state = tt.init_state(ops, WAYPOINTS, cfg.init_piece_time, **F64)
            driver.solve_fused(consts, cfg, state, scene, max_iters=2)
        tt.make_scene(cloud, **F64)
    spans = trace.drain()
    assert trace.drain() == []
    by_id = {s.id: s for s in spans}
    names = [s.name for s in spans]
    assert names == ["trajopt.make_scene", "trajopt.init_state", "trajopt.cache.key",
                     "trajopt.cache.load", "trajopt.graph.launch", "trajopt.cache.clone",
                     "trajopt.solve", "trajopt.make_scene"]
    plan, alone = spans[:-1], spans[-1]
    assert len({s.request for s in plan}) == 1
    assert alone.request != plan[0].request and alone.parent is None
    solve = by_id[plan[-1].id]
    for s in plan:
        if s.name.startswith(("trajopt.cache.", "trajopt.graph.")):
            assert s.parent == solve.id
            assert solve.start_ns <= s.start_ns <= s.end_ns <= solve.end_ns
        else:
            assert s.parent is None
    own = trace.self_ns(spans)
    children = sum(s.end_ns - s.start_ns for s in plan if s.parent == solve.id)
    assert own[solve.id] == solve.end_ns - solve.start_ns - children > 0
    assert own[alone.id] == alone.end_ns - alone.start_ns


def test_fleet_inputs_are_one_span():
    """A fleet's start is one ``trajopt.init_state`` span, not one per robot."""
    cfg = tconfig.TrajOptConfig(res=2)
    ops = sp.build_spline_ops(2, cfg.res)
    wps = [np.array([[-3.0, 0, 0], [0, 0, 0], [3.0, 0, 0]]) + i for i in range(3)]
    with trace.on():
        multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64)
    assert [s.name for s in trace.drain()] == ["trajopt.init_state"]


def test_span_buffer_is_bounded(monkeypatch):
    """Past `trace.MAX_SPANS` spans are dropped and counted until `drain`."""
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.on():
        for _ in range(5):
            with trace.span("trajopt.test"):
                pass
    assert trace.dropped() == 2
    assert len(trace.drain()) == 3 and trace.dropped() == 0


def test_spans_enter_the_profiler_only_under_the_switch():
    """Inside the switch a span is also a ``record_function`` range of a
    recording profiler; outside it a profile holds no ``trajopt.`` range."""
    for on in (False, True):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.on() if on else contextlib.nullcontext():
                with trace.span("trajopt.test"):
                    torch.ones(3).sum()
        names = {e.name for e in prof.events()}
        assert ("trajopt.test" in names) is on
    trace.drain()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_marks_on_card():
    """On the card, a traced fused solve under a profiler opened before its
    capture: 7 mark kernels an iteration and the 2 root marks, timestamps
    in order, the phases and the loop tiling the marks' span, which lies
    within the launch's CUDA events; a second launch of the same start
    counts the same work."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_trace.py)")
    cfg, consts, scene, state0 = single_problem("cuda", torch.float32)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, trace.on():
        _, it, _ = driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
        torch.cuda.synchronize()
    run, iters = graph.LAST_RUN, int(it)
    marks = run.recorder.marks()
    assert [m for m, _ in marks] == [ROOT] + STEP * iters + [ROOT]
    assert all(t0 <= t1 for (_, t0), (_, t1) in zip(marks, marks[1:]))
    phases = run.phases()
    span_ms = (marks[-1][1] - marks[0][1]) * 1e-6
    assert sum(phases[p] for p in trace.PHASES + (trace.LOOP,)) == pytest.approx(span_ms)
    assert 0.9 * run.replay_ms <= span_ms <= run.replay_ms
    kernels = [e for e in prof.events() if "trace_mark_kernel" in e.name
               and e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == trace.MARKS_PER_STEP * iters + trace.ROOT_MARKS
    first = run.counters()
    with trace.on():
        driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
        torch.cuda.synchronize()
    assert graph.LAST_RUN.hit and graph.LAST_RUN.counters() == first
    assert first["planes"] > 0


@pytest.mark.cuda
def test_slack_step_launches_once_a_step_on_card():
    """On the card the slack phase is one `slack_step` launch a step: in the
    host-stepped solve one launch an iteration; in the fused solve one
    kernel node in the captured step, executed once an iteration (the
    nodes' tallies), and the ``slack_rungs`` counter the same on a second
    launch; under ``psd_method="eigh"`` and ``grad_mode="autodiff"`` the
    plain version runs and `slack_step` is not launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_trace.py)")
    from trajopt_tpu_torch.ops import _cuda

    cfg, consts, scene, state0 = single_problem("cuda", torch.float32)
    before = _cuda.LAUNCHES["slack_step"]
    _, history = driver.solve(consts, cfg, state0, scene, max_iters=ITERS)
    assert _cuda.LAUNCHES["slack_step"] - before == len(history)
    with trace.on():
        _, it, _ = driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
        torch.cuda.synchronize()
        run = graph.LAST_RUN
        assert run.kernel_nodes["slack_step"] == 1
        assert run.executions()["slack_step"] == int(it)
        first = run.counters()
        driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
        torch.cuda.synchronize()
        assert graph.LAST_RUN.hit and graph.LAST_RUN.counters() == first
    for options in (dict(psd_method="eigh"), dict(grad_mode="autodiff")):
        other = dataclasses.replace(cfg, **options)
        before = _cuda.LAUNCHES["slack_step"]
        driver.solve(consts, other, state0, scene, max_iters=2)
        assert _cuda.LAUNCHES["slack_step"] == before
