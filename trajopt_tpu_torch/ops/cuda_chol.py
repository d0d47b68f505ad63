"""K3 (modified Cholesky), K4 (Cholesky solve) and their fused launch for
batched tiny blocks.

Replace `trajopt_tpu/ops/pallas_chol.py::_chol_kernel` (wrapped there by
`mod_chol`) and `_solve_kernel` (wrapped by `chol_solve`).  The CUDA kernels
are ``csrc/chol.cu``.  On the card all three are latency-bound: the solver's
blocks are 19 x 19 (PSD repair, slack Newton) or the reduced KKT of at most
64 x 64, one to a few hundred per call, each an m-step (K3) or 2m-step (K4)
dependent recurrence, so what counts is the length of one step and the
number of launches, not bytes or flops.  Design: one warp per block; K3
keeps row i of the trailing matrix in lane i's registers (two rows a lane
for 32 < m <= 64) as a sliding window of a padded width (`route`), so a
column step is a shuffle, a warp max, a square root, a division and one
multiply-add per register, with no shared memory and no barrier on the
chain; K4 keeps all right-hand sides in the same warp, reads L from a
shared copy ahead of the chain, and a step is a shuffle, a division and a
multiply-add; `factor_solve` does both in one launch without L going
through device memory, and neither it nor `mod_chol` writes L when the
caller does not want it.

GMW81 (Gill-Murray-Wright) pivot rule of K3: gamma = max|diag|,
xi = max|offdiag|, beta^2 = max(gamma, xi/sqrt(m^2-1), eps),
delta = eps*max(gamma+xi, 1); pivot j is raised to
max(|d_j|, theta_j^2/beta^2, delta).  It returns L and boosts e >= 0 with
L L^T = h + diag(e).  With ``gmw=False`` it is a plain Cholesky (NaN on a
non-PD block) and e = 0.  The solve divides by the diagonal of L, as its
plain version does (the TPU kernel multiplies by the reciprocal).

Plain versions: `ops/smallchol.py`.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from . import smallchol as sc

MAX_M = 64   # largest block the kernels take (two rows of 64 registers a lane)

# padded widths the kernels are built for (csrc/chol.cu, TRAJOPT_TIERS)
_TIERS = (8, 16, 20, 24, 32, 36, 44, 52, 64)


_ROUTES = tuple(((1 if m <= 32 else 2), next(c for c in _TIERS if c >= m))
                for m in range(MAX_M + 1))


def route(m: int) -> tuple[int, int]:
    """(rows a lane, padded width) of the kernels for m x m blocks: one row
    a lane up to m = 32, two above; the smallest built width >= m (K3's
    register window; K4 reads L from shared memory and uses only the rows)."""
    if not 0 <= m <= MAX_M:
        raise ValueError(f"the Cholesky kernels take m <= {MAX_M}, got {m}")
    return _ROUTES[m]


def mod_chol_plain(h: torch.Tensor, gmw: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    if gmw:
        return sc.mod_cholesky(h)
    return sc.cholesky(h), h.new_zeros(h.shape[:-1])


def chol_solve_plain(l: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return sc.cho_solve(l, rhs)


def factor_solve_plain(
    h: torch.Tensor, rhs: torch.Tensor, gmw: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    l, e = mod_chol_plain(h, gmw)
    return l, e, chol_solve_plain(l, rhs)


def _check_square(name: str, h: torch.Tensor) -> int:
    if h.ndim < 2 or h.shape[-2] != h.shape[-1]:
        raise ValueError(f"{name} expects [..., m, m], got {tuple(h.shape)}")
    return h.shape[-1]


def _check_rhs(name: str, l: torch.Tensor, rhs: torch.Tensor) -> int:
    """Right-hand sides [..., m] or [..., m, k] for blocks l [..., m, m];
    returns k (1 for a vector)."""
    m = _check_square(name, l)
    vec = rhs.ndim == l.ndim - 1
    rhs_mat = rhs.shape[-1:] if vec else rhs.shape[-2:-1]
    if rhs.ndim not in (l.ndim - 1, l.ndim) or tuple(rhs_mat) != (m,) \
            or rhs.shape[: l.ndim - 2] != l.shape[:-2]:
        raise ValueError(
            f"{name} shapes do not match: blocks {tuple(l.shape)}, rhs {tuple(rhs.shape)}"
        )
    return 1 if vec else rhs.shape[-1]


def _gmw_scale(m: int) -> float:
    return max(math.sqrt(m * m - 1), 1.0)


def mod_chol(
    h: torch.Tensor, gmw: bool = True, want_l: bool = True
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Batched (modified) Cholesky: h [..., m, m] -> (l [..., m, m], e [..., m]).
    With ``want_l=False`` l is None and the kernel does not write it.

    CPU tensors take `mod_chol_plain`; CUDA tensors launch K3 (float32,
    contiguous, m <= 64) or raise."""
    m = _check_square("mod_chol", h)
    if h.device.type == "cpu":
        l, e = mod_chol_plain(h, gmw)
        return (l if want_l else None), e
    _cuda.require_cuda_f32("mod_chol", h)
    batch = h.numel() // (m * m) if m else 0
    l = torch.empty_like(h) if want_l else None
    e = torch.empty(h.shape[:-1], dtype=h.dtype, device=h.device)
    err = _cuda.lib().trajopt_mod_chol(
        h.data_ptr(), l.data_ptr() if want_l else None, e.data_ptr(), batch, m, route(m)[1],
        int(gmw), _gmw_scale(m), _cuda.stream()
    )
    _cuda.check_launch(err, "mod_chol", (h.shape, "want_l", int(want_l)))
    return l, e


def chol_solve(l: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = rhs.  l: [..., m, m]; rhs: [..., m] or [..., m, k].

    CPU tensors take `chol_solve_plain`; CUDA tensors launch K4 or raise."""
    nrhs = _check_rhs("chol_solve", l, rhs)
    if l.device.type == "cpu":
        return chol_solve_plain(l, rhs)
    _cuda.require_cuda_f32("chol_solve", l, rhs)
    m = l.shape[-1]
    route(m)
    batch = l.numel() // (m * m) if m else 0
    x = torch.empty_like(rhs)
    err = _cuda.lib().trajopt_chol_solve(
        l.data_ptr(), rhs.data_ptr(), x.data_ptr(), batch, m, nrhs, _cuda.stream()
    )
    _cuda.check_launch(err, "chol_solve", (l.shape, "b", rhs.shape))
    return x


def factor_solve(
    h: torch.Tensor, rhs: torch.Tensor, gmw: bool = True, want_l: bool = True
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """`mod_chol` then `chol_solve` in one launch: (l, e, x) with
    L L^T = h + diag(e) and L L^T x = rhs; l is None with ``want_l=False``.

    CPU tensors take `factor_solve_plain`; CUDA tensors launch the fused
    kernel or raise."""
    nrhs = _check_rhs("factor_solve", h, rhs)
    if h.device.type == "cpu":
        l, e, x = factor_solve_plain(h, rhs, gmw)
        return (l if want_l else None), e, x
    _cuda.require_cuda_f32("factor_solve", h, rhs)
    m = h.shape[-1]
    batch = h.numel() // (m * m) if m else 0
    l = torch.empty_like(h) if want_l else None
    e = torch.empty(h.shape[:-1], dtype=h.dtype, device=h.device)
    x = torch.empty_like(rhs)
    err = _cuda.lib().trajopt_factor_solve(
        h.data_ptr(), rhs.data_ptr(), l.data_ptr() if want_l else None, e.data_ptr(),
        x.data_ptr(), batch, m, route(m)[1], nrhs, int(gmw), _gmw_scale(m), _cuda.stream()
    )
    _cuda.check_launch(err, "factor_solve", (h.shape, "b", rhs.shape))
    return l, e, x


def latency_probe(out: torch.Tensor, steps: int, kind: int) -> None:
    """Launch the one-warp probe of ``csrc/chol.cu``: ``steps`` dependent
    steps shaped like K3's (``kind`` 3) or K4's (4) column step; 0 steps is
    an empty kernel.  ``out``: 64 zeros, float32, on the card.  A
    measurement aid for the kernels' latency floor; no solver path calls
    it and it counts no launch."""
    _cuda.require_cuda_f32("latency_probe", out)
    if out.numel() < 33 or kind not in (3, 4):
        raise ValueError("latency_probe takes a buffer of >= 33 floats and kind 3 or 4")
    err = _cuda.lib().trajopt_chol_probe(out.data_ptr(), steps, kind, _cuda.stream())
    _cuda.check_error(err, "latency_probe")
