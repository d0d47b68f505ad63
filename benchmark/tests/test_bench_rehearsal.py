"""Each cell end to end on the CPU (``--rehearse``: the configuration's
rehearsal sizes, float64), and the same run with the timed path broken
underneath, which has to read ``correct`` false."""

import json

import numpy as np
import pytest
import torch

import run

# `cross_u64.replan` is out of BENCHMARK.json while the program stalls on a
# cloud the reference plans (PERF.md); its files stay, and it rehearses as
# an unlisted cell.
CELLS = ("cross_u64.replan", "bridge_p4.replan")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def result(capsys, cell, seed=2**31 + 11, seconds=1, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace), "--rehearse"])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    line = out.out.strip().splitlines()[-1]
    return json.loads(line), out.err


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_runs_end_to_end(capsys, cell):
    res, err = result(capsys, cell)
    assert set(res) == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert res["device"]["platform"] == "cpu"
    assert res["metrics"] and all(k.startswith("rehearsal.") for k in res["metrics"])
    assert "rehearsal.setup_s" in res["metrics"]
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def _unchanged(step):
    """The step's own work done, its state returned unchanged."""
    def broken(consts, cfg, state, *args, **kwargs):
        out = step(consts, cfg, state, *args, **kwargs)
        return (state,) + tuple(out[1:])
    return broken


def _half(step):
    """Half of the fleet's robots left out of the update."""
    def broken(consts, cfg, state, *args, **kwargs):
        out = step(consts, cfg, state, *args, **kwargs)
        half = state.spline.shape[0] // 2
        new = type(state)(*(torch.cat([n[:half], o[half:]]) for n, o in zip(out[0], state)))
        return (new,) + tuple(out[1:])
    return broken


def _altered(solve):
    """The plan altered where it is produced: its piece times returned 1%
    long, as a wrong time scale would make them."""
    def broken(*args, **kwargs):
        state, it, gnorm = solve(*args, **kwargs)
        return state._replace(piece_time=state.piece_time * 1.01), it, gnorm
    return broken


FAULTS = [("bridge_p4.replan", "unchanged"), ("bridge_p4.replan", "altered"),
          ("cross_u64.replan", "unchanged"), ("cross_u64.replan", "half"),
          ("cross_u64.replan", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_reads_incorrect(capsys, monkeypatch, cell, fault):
    from trajopt_tpu_torch.runtime import cache
    from trajopt_tpu_torch.solver import admm, driver, multi

    cache.clear()
    if fault == "altered":
        for name in ("solve_fused", "solve_fused_multi"):
            monkeypatch.setattr(driver, name, _altered(getattr(driver, name)))
    elif cell.startswith("bridge"):
        monkeypatch.setattr(admm, "admm_step", _unchanged(admm.admm_step))
    else:
        wrap = _unchanged if fault == "unchanged" else _half
        monkeypatch.setattr(multi, "multi_admm_step", wrap(multi.multi_admm_step))
    res, _ = result(capsys, cell)
    cache.clear()
    assert res["correct"] is False
    failing = [k for k, c in res["checks"].items()
               if not (np.float64(c["value"]) <= c["limit"]["max"] if "max" in c["limit"]
                       else np.float64(c["value"]) >= c["limit"]["min"])]
    assert failing, res["checks"]
