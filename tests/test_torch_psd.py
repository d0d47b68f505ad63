"""The PSD repairs of the torch port's Newton blocks, on the CPU in float64:
the Cholesky shift ladder (`gradients.psd_repair_ladder`) and K6's plain
version (`cuda_eig.eigvalsh`) against the JAX package's functions on the
same numpy inputs, every fused driver with ``psd_method="eigh"`` and
``"ladder"`` bit-equal to the host-stepped solve, an unknown method refused
where it is read, and (``slow``) the JAX CPU float64 rows that
chip_smoke.py's phase 8 holds the card's ladder solves to.  The ``cuda``
test holds K6 to float64 on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fused import F64, _assert_equal_trees, fleet_problem, single_problem
from trajopt_tpu.ops import gradients as jgr
from trajopt_tpu_torch import testing
from trajopt_tpu_torch import types as tt
from trajopt_tpu_torch.ops import cuda_eig
from trajopt_tpu_torch.ops import gradients as gr
from trajopt_tpu_torch.solver import admm, driver, multi

torch.set_num_threads(1)


def _close(got, want, rtol):
    """Equal NaN positions, and the finite entries within rtol of the
    largest finite |want|."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=rtol * max(scale, 1e-300))


# ---------------------------------------------------------------------------
# the shift ladder against the JAX package
# ---------------------------------------------------------------------------


def _ladder_blocks(kind):
    """Symmetric blocks for the ladder: indefinite [16,19,19]; positive
    definite [8,19,19] (shift exactly 0); -c I for c = 1, 1e-4, 1e4, where
    H + G I is singular at every rung (tests/test_energies_gradients.py's
    all-fail case: the 1.1 G bump); a NaN in one of three blocks; a
    [2,4,19,19] batch with two leading axes."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(16, 19, 19))
    sym = 0.5 * (a + a.transpose(0, 2, 1)) * 10.0
    if kind == "indefinite":
        return sym
    if kind == "pd":
        return a[:8] @ a[:8].transpose(0, 2, 1) + 0.1 * np.eye(19)
    if kind == "all_fail":
        return -np.array([1.0, 1e-4, 1e4])[:, None, None] * np.eye(19)
    if kind == "nan":
        h = sym[:3].copy()
        h[1, 3, 3] = np.nan
        return h
    return sym[:8].reshape(2, 4, 19, 19)


@pytest.mark.parametrize("kind", ["indefinite", "pd", "all_fail", "nan", "batch"])
def test_psd_repair_ladder_matches_jax(kind):
    """`psd_repair_ladder` against `trajopt_tpu.ops.gradients.psd_repair_ladder`
    at rtol 1e-10; PD blocks come back unchanged, the all-fail blocks
    positive definite, a NaN block unchanged (NaN where JAX's is)."""
    h = _ladder_blocks(kind)
    want = np.asarray(jax.jit(jgr.psd_repair_ladder)(jnp.asarray(h)))
    got = gr.psd_repair_ladder(torch.tensor(h))
    _close(got, want, 1e-10)
    if kind == "pd":
        np.testing.assert_array_equal(got.numpy(), h)
    if kind == "all_fail":
        assert (np.linalg.eigvalsh(got.numpy())[:, 0] > 0).all()
    if kind == "nan":
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(h))


# ---------------------------------------------------------------------------
# K6's plain version against the JAX package
# ---------------------------------------------------------------------------

_EIG_EDGES = testing.eig_edge_blocks(np.random.default_rng(testing.EDGE_SEED + 8))


@pytest.mark.parametrize("name,h", _EIG_EDGES, ids=[c[0] for c in _EIG_EDGES])
def test_eigvalsh_plain_matches_jax(name, h):
    """`cuda_eig.eigvalsh` on a CPU tensor against `jnp.linalg.eigvalsh` on
    the edge blocks chip_smoke.py holds K6 to, rtol 1e-12, ascending.  Only
    finite blocks: the plain version returns what LAPACK leaves for a NaN
    block (K6 returns NaN; `psd_repair` hands neither such a block)."""
    h = h[np.isfinite(h).all(axis=(1, 2))]
    want = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(h)))
    got = cuda_eig.eigvalsh(torch.tensor(h))
    assert got.shape == h.shape[:-1]
    _close(got, want, 1e-12)
    assert (np.diff(got.numpy(), axis=-1) >= 0).all()


def test_eigvalsh_kernel_route_refuses_what_it_cannot_take():
    """Off the CPU the wrapper goes to K6, which takes m <= 32 (one lane a
    row): m = 33 raises ValueError before anything is built, as does a
    block that is not square; float64 raises TypeError."""
    with pytest.raises(ValueError, match="m <= 32"):
        cuda_eig.eigvalsh(torch.empty(2, 33, 33, device="meta"))
    with pytest.raises(ValueError, match=r"\[\.\.\., m, m\]"):
        cuda_eig.eigvalsh(torch.empty(2, 3, 4, device="meta"))
    with pytest.raises(TypeError, match="float32"):
        cuda_eig.eigvalsh(torch.empty(2, 19, 19, dtype=torch.float64, device="meta"))


# ---------------------------------------------------------------------------
# unknown methods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["direction", "slack", "fused"])
def test_unknown_psd_method_raises(where):
    """Every name but "gmw", "eigh" and "ladder" raises ValueError where the
    method is read: the spline direction's repair, the slack Newton step,
    and the fused drivers (their first step).  The JAX package takes GMW
    for an unknown name in the direction and the ladder in the slack step
    (ROADMAP.md Queue 3)."""
    cfg, consts, scene, state = single_problem(psd_method="lu")
    with pytest.raises(ValueError, match="psd_method 'lu'"):
        if where == "direction":
            gr.apply_psd_repair(cfg, torch.eye(19, **F64)[None])
        elif where == "slack":
            admm.slack_update(consts, cfg, state)
        else:
            driver.solve_fused(consts, cfg, state, scene, max_iters=2)


# ---------------------------------------------------------------------------
# every fused driver against the host-stepped solve
# ---------------------------------------------------------------------------


def _host_stepped_loop(step, carry, max_iters, stop):
    """The fused loop's condition on the host: at most ``max_iters`` steps,
    stopping after the second once gnorm < stop."""
    for it in range(max_iters):
        carry, gnorm = step(carry)
        if it >= 1 and float(gnorm) < stop:
            return carry, it + 1
    return carry, max_iters


KINDS = ["single", "coupled", "decoupled", "cached", "batch", "batch_multi"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", ["eigh", "ladder"])
def test_fused_equals_host_stepped_with_psd_method(method, kind):
    """`solve_fused`, `solve_fused_multi` (coupled, decoupled),
    `solve_fused_multi_cached`, `solve_fused_batch` (three single UAVs) and
    `solve_fused_batch_multi` (two fleets of two) with ``method``: the
    host-stepped step's iterations, at most 9 (the repairs shift blocks from
    the fifth on: `test_psd_methods_repair_on_the_fused_paths`), and a
    bit-equal state."""
    if kind in ("single", "batch"):
        cfg, consts, scene, state = single_problem(psd_method=method)
    else:
        cfg, consts, scene, state = fleet_problem(psd_method=method,
                                                  optimal_plane=kind == "cached")
    if kind == "single":
        step = driver.fused_step(consts, cfg, scene)
        fused = driver.solve_fused(consts, cfg, state, scene, max_iters=9)
    elif kind in ("coupled", "decoupled"):
        step = driver.fused_step(consts, cfg, scene, kind == "coupled")
        fused = driver.solve_fused_multi(consts, cfg, state, scene, kind == "coupled",
                                         max_iters=9)
    elif kind == "cached":
        caches = multi.init_multi_caches(cfg, consts, 2, **F64)
        step = driver.fused_step(consts, cfg, scene, True, cached=True)
        fused = driver.solve_fused_multi_cached(consts, cfg, state, scene, True, caches,
                                                max_iters=9)
        state = (state, caches)
    elif kind == "batch":
        state = tt.SolverState(*(torch.stack([x, x, x]) for x in state))
        state = state._replace(spline=state.spline + torch.tensor(
            [0.0, 0.05, 0.1], **F64)[:, None, None])
        step = driver.fused_step(consts, cfg, scene, False, interact=False)
        fused = driver.solve_fused_batch(consts, cfg, state, scene, max_iters=9)
    else:
        lift = torch.tensor([0.0, 0.0, 0.3], **F64)
        state = tt.SolverState(*(torch.stack([x, x]) for x in state))
        state = state._replace(spline=torch.stack([state.spline[0], state.spline[1] + lift]))
        fused = driver.solve_fused_batch_multi(consts, cfg, state, scene, True, max_iters=9)
        state = tt.SolverState(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in state))
        step = driver.fused_step(consts, cfg, scene, True, groups=2)
    carry, n_iters = _host_stepped_loop(step, state if kind == "cached" else (state,), 9,
                                         cfg.stop)
    got, it = fused[0], int(fused[1])
    assert it == n_iters
    host = carry[0]
    if kind == "batch_multi":
        got = tt.SolverState(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in got))
    _assert_equal_trees(tuple(got), tuple(host))
    if kind == "cached":
        _assert_equal_trees(tuple(fused[3]), tuple(carry[1]))


@pytest.mark.parametrize("method", ["eigh", "ladder"])
def test_psd_methods_repair_on_the_fused_paths(monkeypatch, method):
    """The single problem of the fused tests above gives the repair work:
    a block of its first six steps is indefinite, and the method makes it
    positive definite (else those tests would not tell the methods from a
    no-op)."""
    cfg, consts, scene, state = single_problem(psd_method=method)
    least = []
    real = gr.apply_psd_repair

    def spy(c, h):
        out = real(c, h)
        least.append((float(torch.linalg.eigvalsh(h).min()), float(torch.linalg.eigvalsh(out).min())))
        return out

    monkeypatch.setattr(gr, "apply_psd_repair", spy)
    for _ in range(6):
        state, _ = admm.admm_step(consts, cfg, state, scene)
    assert min(before for before, _ in least) < 0
    assert min(after for _, after in least) > 0


# ---------------------------------------------------------------------------
# the rows phase 8 holds the card to
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_jax_rows_of_the_ladder_gates():
    """`testing.PSD_JAX_ROWS`, which chip_smoke.py's phase 8 holds the card's
    ``psd_method="ladder"`` solves to, are what the JAX package computes
    (~3 min)."""
    from tests.test_torch_optimal_plane import jax_rows

    rows = {f"{name} ladder": row for name, row in jax_rows(psd_method="ladder").items()}
    assert set(rows) == set(testing.PSD_JAX_ROWS)
    for name, row in rows.items():
        want = testing.PSD_JAX_ROWS[name]
        assert row["iters"] == want["iters"] and row["converged"] == want["converged"], name
        for key in ("ccd_time", "ccd_len", "min_clearance"):
            assert row[key] == pytest.approx(want[key], rel=1e-6), (name, key)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_eigvalsh_kernel_matches_float64_on_card():
    """Builds the kernels and runs chip_smoke.py's K6 check: the edge blocks
    and the solver's Hessians within 1e-5 |H|_F of float64, NaN in, NaN
    out."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python3 chip_smoke.py)")
    import chip_smoke

    device = torch.device("cuda")
    assert chip_smoke.check_eig(device, lambda s: None, chip_smoke.psd_call_inputs(device)) >= 0.0
    with pytest.raises(TypeError, match="float32"):
        cuda_eig.eigvalsh(torch.eye(4, dtype=torch.float64, device="cuda")[None])
