"""The direction phase's kernels (`trajopt_tpu_torch/ops/cuda_direction.py`,
``csrc/direction.cu``): their bindings and refusals on the CPU, and on the
card each kernel against its plain slice and the whole chain against
`admm.spline_direction_plain`, both against float64 (`chip_smoke.
check_direction_case`; the ``cuda``-marked tests skip here).  The file
imports no JAX, so that on a card machine ``python -m pytest --noconftest
-m cuda tests/test_torch_direction.py`` runs it."""

import ctypes
import re

import pytest
import torch

from trajopt_tpu_torch import testing
from trajopt_tpu_torch.ops import _cuda, cuda_chol
from trajopt_tpu_torch.ops import cuda_direction as cd
from trajopt_tpu_torch.runtime import trace

torch.set_num_threads(1)


def _c_params(text: str, name: str) -> list[str]:
    """The parameter types of the C entry point ``name`` in ``text``."""
    body = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
    return [re.sub(r"\s*\w+$", "", p.strip()) for p in body.split(",")]


@pytest.mark.parametrize("kernel", cd.KERNELS)
def test_direction_kernels_are_built_bound_and_counted(kernel):
    """``csrc/direction.cu`` is in the build's hash; each C entry point's
    ctypes signature has a pointer for every pointer, an int for every int
    and a float for every float; each kernel is counted; no kernel's name
    contains a name the benchmark's roofline shares read from a trace."""
    text = (_cuda.CSRC / "direction.cu").read_text()
    assert "direction.cu" in _cuda.SOURCES
    params = _c_params(text, f"trajopt_{kernel}")
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if p == "float" else ctypes.c_int
             for p in params]
    assert all("*" in p or p in ("int", "float") for p in params)
    assert kinds == _cuda._SIGNATURES[f"trajopt_{kernel}"]
    assert kernel in _cuda.LAUNCHES
    assert f"{kernel}_kernel(" in text
    for read in ("mod_chol_kernel", "chol_solve_kernel", "factor_solve_kernel", "smallest_k_",
                 "gjk_exact_kernel"):
        assert read not in f"{kernel}_kernel"


def _meta(x, dtype):
    return type(x)(*(t.to("meta", dtype) if t.is_floating_point() else t.to("meta") for t in x))


def test_direction_kernels_take_card_float32_only():
    """Each wrapper takes its plain version for CPU tensors and otherwise
    launches or raises: float64 raises TypeError, a tensor off the card
    ValueError; none falls back to the plain version."""
    consts, cfg, state, planes = testing.direction_case(4, "planes")
    g, h = cd.dir_grad_hess(consts, cfg, state, planes)
    _, e = cuda_chol.mod_chol(h, want_l=False)
    asm = cd.dir_assemble(consts, g, h, e)
    _, _, x = cuda_chol.factor_solve(asm.a, asm.rhs)
    sch = cd.dir_schur(asm.red, x)
    calls = [
        lambda m: cd.dir_grad_hess(consts, cfg, m(state), m(planes)),
        lambda m: cd.dir_assemble(consts, *m((g, h, e))),
        lambda m: cd.dir_schur(m(asm.red), m((x,))[0]),
        lambda m: cd.dir_finish(consts, m(asm.red), m(sch), m((sch.r_s,))[0]),
    ]
    for call in calls:
        for dtype, error, match in ((torch.float64, TypeError, "float32"),
                                    (torch.float32, ValueError, "CUDA")):
            with pytest.raises(error, match=match):
                call(lambda x: _meta(x, dtype) if hasattr(x, "_fields") else
                     tuple(t.to("meta", dtype) for t in x))


@pytest.mark.parametrize("case", testing.DIRECTION_CASES, ids=[c[0] for c in testing.DIRECTION_CASES])
def test_direction_cases_reach_their_edges(case):
    """Each of `testing.DIRECTION_CASES` does what its name says, on the
    plain path in float64: no live plane on the bridge, live ones in the
    barrier band otherwise, a GMW boost (K3's plain version) on every piece
    of "gmw", a velocity (or acceleration) bound in its band, the fallback
    taken where t_lambda is NaN and nowhere else, and ns = 9 P - 3."""
    from trajopt_tpu_torch.ops import energies as en
    from trajopt_tpu_torch.solver import admm

    name, pieces, edge = case
    consts, cfg, state, planes = testing.direction_case(pieces, edge)
    hull = en.seg_cps(consts, state.spline)
    dist = torch.einsum("prjd,prkd->prkj", hull, planes.c) + planes.d[..., None]
    live = int((planes.mask[..., None] & (dist > 0) & (dist < cfg.margin)).sum())
    assert (live == 0) is (edge == "dead")
    _, h = cd.dir_grad_hess_plain(consts, cfg, state, planes)
    _, e = cuda_chol.mod_chol(h, want_l=False)
    assert bool((e > 0).any(-1).all()) is (edge == "gmw")
    w = consts.seg_weight[:, None]
    vel = 5.0 * torch.diff(hull, dim=2)
    band = lambda d: int(((d > 0) & (d < cfg.margin)).sum())
    vel_live = band(cfg.vel_limit - vel.norm(dim=-1) / (w * state.piece_time))
    acc_live = band(cfg.acc_limit - (4.0 * torch.diff(vel, dim=2)).norm(dim=-1)
                    / (w * w * state.piece_time ** 2))
    assert (vel_live > 0) is (edge == "vel") and (acc_live > 0) is (edge in ("vel", "acc"))
    with trace.on() as rec:
        sd = admm.spline_direction_plain(consts, cfg, state, planes)
    assert rec.counters()["direction_fallbacks"] == (edge == "nan")
    assert bool(torch.isfinite(sd.direction).all())
    assert 3 * (consts.trajectory_num - 4) == 9 * pieces - 3


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.DIRECTION_CASES, ids=[c[0] for c in testing.DIRECTION_CASES])
def test_direction_kernels_match_plain_on_card(case):
    """On the card each of the four kernels is launched once and held to its
    plain slice on the same float32 inputs, and the chain to
    `admm.spline_direction_plain`: each output's error against the plain
    version in float64 on the same inputs at most 4 times the plain float32
    version's plus 1e-5 x its scale, NaN and inf in the same places, the
    fallback flag equal (`chip_smoke.check_direction_case`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_direction.py)")
    import chip_smoke

    errs = chip_smoke.check_direction_case(case, torch.device("cuda"), print)
    assert set(errs) == set(cd.KERNELS)
