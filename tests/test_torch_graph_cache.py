"""The fused drivers' graph cache (`trajopt_tpu_torch/runtime/cache.py`,
the port's counterpart of ``jax.jit``'s executable cache), on the CPU in
float64, where an entry runs the loop eagerly over its own buffers: a
second call of the same key hits and equals an uncached solve bit for bit
and the JAX package's ``solve_fused`` to rtol 1e-8; a new start, scene or
set of constants of the same shapes is read by value; a result is never
overwritten by a later call; each key field captures again; the cached
multi-robot driver returns fresh plane caches; both batch drivers hit; the
least recently used entry goes first and `cache.clear` drops every entry;
a failed solve leaves no entry.  The ``cuda``-marked tests hold a hit to
the miss on a card and skip here; the file imports JAX only inside the
test that compares with it, so that on a card machine, which has no JAX,
``python -m pytest --noconftest -m cuda tests/test_torch_graph_cache.py``
runs them."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from trajopt_tpu_torch import config as tconfig
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import splines as sp
from trajopt_tpu_torch.parallel import sharded
from trajopt_tpu_torch.runtime import cache, graph, trace
from trajopt_tpu_torch.scenes import generators as gen
from trajopt_tpu_torch.solver import admm, driver, multi

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
ITERS = 6            # fused iterations of the single-UAV solves (none converges before)
KEY_ITERS = 2        # of the key-field cases

WAYPOINTS = np.array([[-3.0, 0.0, 0.0], [-1.0, 1.7, 0.0], [1.0, 1.7, 0.0], [3.0, 0.0, 0.0]])


def single_problem():
    """tests/test_torch_fused.py's single-UAV problem: res 2, 3 pieces
    around a sphere of 200 points."""
    cfg = tconfig.TrajOptConfig(res=2, max_planes=8, max_ccd_candidates=8)
    ops = sp.build_spline_ops(len(WAYPOINTS) - 1, cfg.res)
    cloud = gen.sphere_scene(n_points=200, radius=1.0, seed=1)
    return (cfg, tt.device_consts(ops, **F64), tt.make_scene(cloud, **F64),
            tt.init_state(ops, WAYPOINTS, cfg.init_piece_time, **F64))


def fleet_problem(**options):
    """tests/test_torch_fused.py's fleet problem: two robots crossing at
    right angles 0.15 apart vertically, res 2, 2 pieces, a sphere of 200
    points 0.12 from the first robot's path."""
    cfg = tconfig.TrajOptConfig(res=2, max_planes=4, max_self_planes=2, max_ccd_candidates=4,
                                ks=1e-3, **options)
    t = np.linspace(0, 1, 3)[:, None]
    wps = [np.array([-3.0, 0, 0]) * (1 - t) + np.array([3.0, 0, 0]) * t,
           np.array([0, -3.0, 0.15]) * (1 - t) + np.array([0, 3.0, 0.15]) * t]
    ops = sp.build_spline_ops(2, cfg.res)
    cloud = gen.sphere_scene(200, radius=0.3, center=(1.5, 0.42, 0.0))
    return (cfg, tt.device_consts(ops, **F64), tt.make_scene(cloud, **F64),
            multi.init_multi_state(ops, wps, cfg.init_piece_time, **F64))


def _assert_equal_trees(a, b):
    """Every leaf equal bit for bit, with its dtype."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(autouse=True)
def _empty_cache():
    cache.clear()
    yield
    cache.clear()


def _moved(state, seed, scale=1e-3):
    """``state`` with its spline moved by seeded normal noise: a new start
    of the same shapes."""
    noise = np.random.default_rng(seed).normal(scale=scale, size=tuple(state.spline.shape))
    return state._replace(spline=state.spline + torch.as_tensor(noise, dtype=state.spline.dtype))


def _clone(tree):
    return graph._tree_map(torch.clone, tree)


def _hit() -> bool:
    return graph.LAST_RUN.hit


def _storages(tree) -> set:
    return {x.untyped_storage().data_ptr() for x in graph._leaves(tree)}


# ---------------------------------------------------------------------------
# solve_fused: a second call hits, equals an uncached solve and JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_runs():
    """Two `solve_fused` calls of the small single-UAV problem, from its
    start and from a moved one, with what each left in `graph.LAST_RUN`."""
    cache.clear()
    cfg, consts, scene, state0 = single_problem()
    other = _moved(state0, 0)
    first = driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
    first_run = graph.LAST_RUN
    kept = _clone(first)
    second = driver.solve_fused(consts, cfg, other, scene, max_iters=ITERS)
    out = dict(cfg=cfg, consts=consts, scene=scene, other=other, first=first, kept=kept,
               second=second, runs=(first_run, graph.LAST_RUN), size=cache.size())
    cache.clear()
    return out


def test_second_call_of_the_same_shapes_hits(single_runs):
    """The first call misses and the second, from another start, hits the
    one entry; both ran all ``ITERS`` iterations on the CPU's branch form."""
    first_run, second_run = single_runs["runs"]
    assert (first_run.hit, second_run.hit) == (False, True)
    assert first_run.form == second_run.form == "branch"
    assert single_runs["size"] == 1
    assert int(single_runs["second"][1]) == ITERS


def test_hit_equals_an_uncached_solve(single_runs):
    """The hit's state, iterations and gnorm equal `graph.run_fused` over a
    fresh `driver.fused_step` from the same start, bit for bit."""
    r = single_runs
    (want,), it, gnorm = graph.run_fused(driver.fused_step(r["consts"], r["cfg"], r["scene"]),
                                         (r["other"],), ITERS, r["cfg"].stop)
    _assert_equal_trees(r["second"], (want, it, gnorm))


def test_hit_matches_jax_solve_fused(single_runs):
    """The hit against the JAX package's `solve_fused` (its CPU path) from
    the same moved start: the same iterations, state and gnorm to rtol
    1e-8."""
    jnp = pytest.importorskip("jax.numpy")
    from trajopt_tpu import types as jt
    from trajopt_tpu.config import TrajOptConfig
    from trajopt_tpu.ops import splines as jsp
    from trajopt_tpu.scenes import generators as jgen
    from trajopt_tpu.solver import driver as jdriver

    cfg = TrajOptConfig(res=2, max_planes=8, max_ccd_candidates=8)
    ops = jsp.build_spline_ops(len(WAYPOINTS) - 1, cfg.res)
    jscene = jt.make_scene(jgen.sphere_scene(n_points=200, radius=1.0, seed=1))
    jstate = jt.SolverState(*(jnp.asarray(x.numpy()) for x in single_runs["other"]))
    jfinal, jit_, jgnorm = jdriver.solve_fused(jt.device_consts(ops), cfg, jstate, jscene,
                                               max_iters=ITERS)
    state, it, gnorm = single_runs["second"]
    assert int(it) == int(jit_)
    for got, want in zip((*state, gnorm), (*jfinal, jgnorm)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                                   atol=1e-8 * max(float(np.abs(want).max()), 1e-300))


def test_a_later_call_leaves_an_earlier_result_untouched(single_runs):
    """The first call's tensors hold its result after the second call, and
    the two results share no storage (each call returns clones)."""
    r = single_runs
    _assert_equal_trees(r["first"], r["kept"])
    assert not _storages(r["first"]) & _storages(r["second"])
    assert not torch.equal(r["first"][0].spline, r["second"][0].spline)


@pytest.mark.parametrize("what", ["scene", "consts"])
def test_new_scene_or_constants_of_the_same_shape_are_read_by_value(what):
    """A scene (the sphere of as many points moved 0.5 towards the path,
    into its barrier's reach) or constants (the jerk matrix doubled) of the
    same shapes hit, and the result equals a fresh
    solve on the new values and differs from the old values' result."""
    cfg, consts, scene, state0 = single_problem()
    old = driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
    if what == "scene":
        scene = tt.make_scene(gen.sphere_scene(n_points=200, radius=1.0, center=(0.0, 0.5, 0.0),
                                                seed=2), **F64)
    else:
        consts = consts._replace(m_dyn=2.0 * consts.m_dyn)
    new = driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
    assert _hit() and cache.size() == 1
    (want,), it, gnorm = graph.run_fused(driver.fused_step(consts, cfg, scene), (state0,), ITERS,
                                         cfg.stop)
    _assert_equal_trees(new, (want, it, gnorm))
    assert not all(torch.equal(a, b) for a, b in zip(new[0], old[0]))


# ---------------------------------------------------------------------------
# every key field captures again
# ---------------------------------------------------------------------------


FIVE_WAYPOINTS = np.array([[-3.0, 0.0, 0.0], [-1.5, 1.7, 0.0], [0.0, 2.0, 0.0], [1.5, 1.7, 0.0],
                           [3.0, 0.0, 0.0]])


def _single_call(variant=None):
    """A `solve_fused` call of the small single-UAV problem, ``variant``
    naming the one key field it changes."""
    cfg, consts, scene, state = single_problem()
    max_iters = KEY_ITERS + (variant == "max_iters")
    if variant == "stop":
        cfg = cfg.replace(stop=0.5)
    elif variant == "pieces":
        ops = sp.build_spline_ops(len(FIVE_WAYPOINTS) - 1, cfg.res)
        consts = tt.device_consts(ops, **F64)
        state = tt.init_state(ops, FIVE_WAYPOINTS, cfg.init_piece_time, **F64)
    elif variant == "points":
        scene = tt.make_scene(gen.sphere_scene(n_points=240, radius=1.0, seed=1), **F64)
    elif variant == "dtype":
        f32 = lambda tree: type(tree)(*(x.float() if x.is_floating_point() else x for x in tree))
        consts, scene, state = f32(consts), f32(scene), f32(state)
    driver.solve_fused(consts, cfg, state, scene, max_iters=max_iters)


def _fleet_call(variant=None, monkeypatch=None):
    """A `solve_fused_multi` call of the small crossing pair, ``variant``
    naming the one key field it changes."""
    if variant == "form":
        # the nodes' CPU stand-in instead of the CPU's branch form
        monkeypatch.setattr(driver, "fused_form", lambda device, axis: "conditional")
    cfg, consts, scene, state = fleet_problem()
    options = dict(coupled=variant != "coupled", interact=variant != "interact",
                   groups=2 if variant == "groups" else 1)
    driver.solve_fused_multi(consts, cfg, state, scene, max_iters=KEY_ITERS, **options)


FLEET_FIELDS = ["coupled", "interact", "groups", "form"]
KEY_FIELDS = ["stop", "max_iters", "pieces", "points", "dtype", "counting"] + FLEET_FIELDS


@pytest.mark.parametrize("field", KEY_FIELDS)
def test_each_key_field_captures_again(field, monkeypatch):
    """The unchanged call hits its own entry, and the call with ``field``
    changed misses and adds a second entry."""
    base = _fleet_call if field in FLEET_FIELDS else _single_call
    base()
    base()
    assert _hit() and cache.size() == 1
    if field in FLEET_FIELDS:
        _fleet_call(field, monkeypatch)
    elif field == "counting":
        with trace.on():
            _single_call()
    else:
        _single_call(field)
    assert not _hit() and cache.size() == 2


def test_process_group_is_a_key_field():
    """A sharded call (a single-rank gloo group) misses beside the
    unsharded one, and a second sharded call hits, equal to the first."""
    cfg, consts, scene, state = fleet_problem()
    driver.solve_fused_multi(consts, cfg, state, scene, True, max_iters=KEY_ITERS)
    mesh = sharded.make_mesh(1, device_type="cpu")
    try:
        group = mesh.get_group(sharded.ROBOT_AXIS)
        first = driver.solve_fused_multi(consts, cfg, state, scene, True, max_iters=KEY_ITERS,
                                         axis_name=group)
        assert not _hit() and cache.size() == 2
        second = driver.solve_fused_multi(consts, cfg, state, scene, True, max_iters=KEY_ITERS,
                                          axis_name=group)
        assert _hit() and cache.size() == 2
        _assert_equal_trees(first, second)
    finally:
        cache.clear()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the plane caches, the batch drivers
# ---------------------------------------------------------------------------


def test_cached_driver_returns_fresh_plane_caches_and_hits():
    """`solve_fused_multi_cached` from another start hits; state, caches,
    iterations and gnorm equal an uncached solve bit for bit; the caches it
    returns are filled, share no storage with its input caches or the first
    call's, and the first call's are untouched by the second."""
    cfg, consts, scene, state0 = fleet_problem(optimal_plane=True)
    caches = multi.init_multi_caches(cfg, consts, 2, **F64)
    first = driver.solve_fused_multi_cached(consts, cfg, state0, scene, True, caches, max_iters=4)
    assert not _hit()
    kept = _clone(first)
    moved = _moved(state0, 1)
    second = driver.solve_fused_multi_cached(consts, cfg, moved, scene, True, caches, max_iters=4)
    assert _hit() and cache.size() == 1
    (state, got_caches), it, gnorm = graph.run_fused(
        driver.fused_step(consts, cfg, scene, True, cached=True), (moved, tuple(caches)), 4,
        cfg.stop)
    _assert_equal_trees(second, (state, it, gnorm, got_caches))
    _assert_equal_trees(first, kept)
    assert bool((second[3][0].obs_id >= 0).any()) and bool((second[3][1].partner >= 0).any())
    assert not _storages(second[3]) & (_storages(tuple(caches)) | _storages(first[3]))


def _batch(seed):
    """Three single UAVs sharing the sphere, jittered from ``seed``."""
    cfg, consts, scene, state = single_problem()
    return cfg, consts, scene, _moved(tt.stack([state] * 3), seed)


def _fleet_batch(seed):
    """Two fleets of the crossing pair, [2, 2, ...], jittered from ``seed``."""
    cfg, consts, scene, state = fleet_problem()
    return cfg, consts, scene, _moved(tt.stack([state] * 2), seed, scale=1e-2)


@pytest.mark.parametrize("kind", ["batch", "batch_multi"])
def test_batch_drivers_hit(kind):
    """`solve_fused_batch` and `solve_fused_batch_multi` with new jitter of
    the same shapes hit, and equal an uncached solve bit for bit."""
    build = _batch if kind == "batch" else _fleet_batch
    cfg, consts, scene, states = build(0)
    solve = lambda s: (driver.solve_fused_batch(consts, cfg, s, scene, max_iters=3)
                       if kind == "batch" else
                       driver.solve_fused_batch_multi(consts, cfg, s, scene, max_iters=3))
    solve(states)
    assert not _hit()
    states = build(1)[3]
    got = solve(states)
    assert _hit() and cache.size() == 1
    if kind == "batch":
        step = driver.fused_step(consts, cfg, scene, False, interact=False)
        (want,), it, gnorm = graph.run_fused(step, (states,), 3, cfg.stop)
    else:
        flat = tt.SolverState(*(x.reshape((4,) + tuple(x.shape[2:])) for x in states))
        step = driver.fused_step(consts, cfg, scene, True, groups=2)
        (want,), it, gnorm = graph.run_fused(step, (flat,), 3, cfg.stop)
        want = tt.SolverState(*(x.reshape((2, 2) + tuple(x.shape[1:])) for x in want))
    _assert_equal_trees(got, (want, it, gnorm))


# ---------------------------------------------------------------------------
# the bound, clear, a failure
# ---------------------------------------------------------------------------


def test_least_recently_used_entry_goes_first_and_clear_drops_all(monkeypatch):
    """With room for 2 entries (keys by ``max_iters``): a hit makes its
    entry the most recent, a third key drops the least recent, and
    `cache.clear` drops them all."""
    monkeypatch.setattr(cache, "MAX_ENTRIES", 2)
    cfg, consts, scene, state0 = single_problem()
    hits = []

    def solve(n):
        driver.solve_fused(consts, cfg, state0, scene, max_iters=n)
        hits.append(_hit())

    for n in (1, 2, 1, 3, 1, 2, 3):
        solve(n)
        assert cache.size() <= 2
    # 1 and 2 miss, 1 hits, 3 drops 2, 1 hits, 2 drops 3, 3 drops 1
    assert hits == [False, False, True, False, True, False, False]
    cache.clear()
    assert cache.size() == 0
    solve(1)
    assert hits[-1] is False and cache.size() == 1


def test_a_failed_solve_raises_and_leaves_no_entry(monkeypatch):
    """A step that raises on a miss raises from the driver and leaves no
    entry: the next call captures again."""
    cfg, consts, scene, state0 = single_problem()

    def fail(*args, **kwargs):
        raise RuntimeError("step failed")

    monkeypatch.setattr(admm, "admm_step", fail)
    with pytest.raises(RuntimeError, match="step failed"):
        driver.solve_fused(consts, cfg, state0, scene, max_iters=KEY_ITERS)
    assert cache.size() == 0
    monkeypatch.undo()
    driver.solve_fused(consts, cfg, state0, scene, max_iters=KEY_ITERS)
    assert not _hit() and cache.size() == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _on_card(problem):
    """``problem`` (cfg and float64 containers on the CPU) in float32 on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_graph_cache.py)")
    cfg, *trees = problem
    to = lambda tree: type(tree)(*(x.to("cuda", torch.float32) if x.is_floating_point()
                                   else x.to("cuda") for x in tree))
    return cfg, *(to(tree) for tree in trees)


@pytest.mark.cuda
@pytest.mark.parametrize("empty_cache", [False, True], ids=["held", "after_empty_cache"])
def test_hit_equals_the_miss_on_card(empty_cache):
    """On the card a hit launches the captured graph (warm-up and capture
    0, one launch) and, from the miss's start, gives its state bit for bit,
    also after `torch.cuda.empty_cache`; the miss's result is untouched."""
    cfg, consts, scene, state0 = _on_card(single_problem())
    first = driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
    kept = _clone(first)
    moved = state0._replace(spline=state0.spline + 1e-3)
    driver.solve_fused(consts, cfg, moved, scene, max_iters=ITERS)
    if empty_cache:
        torch.cuda.empty_cache()
    again = driver.solve_fused(consts, cfg, state0, scene, max_iters=ITERS)
    run = graph.LAST_RUN
    torch.cuda.synchronize()
    assert run.hit and run.replays == 1 and run.warmup_ms == run.capture_ms == 0.0
    _assert_equal_trees(again, first)
    _assert_equal_trees(first, kept)


@pytest.mark.cuda
def test_multi_hit_equals_the_miss_on_card():
    """The coupled crossing pair: a hit from a moved start, then from the
    first start, bit-equal to the miss."""
    cfg, consts, scene, state0 = _on_card(fleet_problem())
    first = driver.solve_fused_multi(consts, cfg, state0, scene, True, max_iters=4)
    driver.solve_fused_multi(consts, cfg, state0._replace(spline=state0.spline + 1e-3), scene,
                             True, max_iters=4)
    again = driver.solve_fused_multi(consts, cfg, state0, scene, True, max_iters=4)
    assert graph.LAST_RUN.hit
    _assert_equal_trees(again, first)
