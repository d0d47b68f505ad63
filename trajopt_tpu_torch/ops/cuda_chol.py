"""K3 (modified Cholesky) and K4 (Cholesky solve) for batched tiny blocks.

Replace `trajopt_tpu/ops/pallas_chol.py::_chol_kernel` (wrapped there by
`mod_chol`) and `_solve_kernel` (wrapped by `chol_solve`).  The CUDA kernels
are ``csrc/chol.cu``.  On the card both are latency-bound: the solver's
blocks are 19 x 19 (PSD repair, slack Newton) or the reduced KKT of at most
64 x 64, a few per iteration, each an m-step dependent recurrence.  Design:
one warp per block with the matrix in shared memory (<= 16 KB) and
warp-synchronous column steps, so a factorization needs no block barriers.

GMW81 (Gill-Murray-Wright) pivot rule of K3: gamma = max|diag|,
xi = max|offdiag|, beta^2 = max(gamma, xi/sqrt(m^2-1), eps),
delta = eps*max(gamma+xi, 1); pivot j is raised to
max(|d_j|, theta_j^2/beta^2, delta).  It returns L and boosts e >= 0 with
L L^T = h + diag(e).  With ``gmw=False`` it is a plain Cholesky (NaN on a
non-PD block) and e = 0.

Plain versions: `ops/smallchol.py`.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from . import smallchol as sc

MAX_M = 64   # largest block the kernels take (64 x 64 floats of shared memory)


def mod_chol_plain(h: torch.Tensor, gmw: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    if gmw:
        return sc.mod_cholesky(h)
    return sc.cholesky(h), h.new_zeros(h.shape[:-1])


def chol_solve_plain(l: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return sc.cho_solve(l, rhs)


def mod_chol(h: torch.Tensor, gmw: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched (modified) Cholesky: h [..., m, m] -> (l [..., m, m], e [..., m]).

    CPU tensors take `mod_chol_plain`; CUDA tensors launch K3 (float32,
    contiguous, m <= 64) or raise."""
    m = h.shape[-1]
    if h.ndim < 2 or h.shape[-2] != m:
        raise ValueError(f"mod_chol expects [..., m, m], got {tuple(h.shape)}")
    if h.device.type == "cpu":
        return mod_chol_plain(h, gmw)
    _cuda.require_cuda_f32("mod_chol", h)
    if m > MAX_M:
        raise ValueError(f"mod_chol kernel takes m <= {MAX_M}, got {m}")
    batch = h.numel() // (m * m) if m else 0
    l = torch.empty_like(h)
    e = torch.empty(h.shape[:-1], dtype=h.dtype, device=h.device)
    nf = max(math.sqrt(m * m - 1), 1.0)
    err = _cuda.lib().trajopt_mod_chol(
        h.data_ptr(), l.data_ptr(), e.data_ptr(), batch, m, int(gmw), nf, _cuda.stream()
    )
    _cuda.check_launch(err, "mod_chol")
    return l, e


def chol_solve(l: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = rhs.  l: [..., m, m]; rhs: [..., m] or [..., m, k].

    CPU tensors take `chol_solve_plain`; CUDA tensors launch K4 or raise."""
    m = l.shape[-1]
    vec = rhs.ndim == l.ndim - 1
    rhs_mat = rhs.shape[-1:] if vec else rhs.shape[-2:-1]
    if l.shape[-2] != m or tuple(rhs_mat) != (m,) or rhs.shape[: l.ndim - 2] != l.shape[:-2]:
        raise ValueError(
            f"chol_solve shapes do not match: l {tuple(l.shape)}, rhs {tuple(rhs.shape)}"
        )
    if l.device.type == "cpu":
        return chol_solve_plain(l, rhs)
    _cuda.require_cuda_f32("chol_solve", l, rhs)
    if m > MAX_M:
        raise ValueError(f"chol_solve kernel takes m <= {MAX_M}, got {m}")
    batch = l.numel() // (m * m) if m else 0
    nrhs = 1 if vec else rhs.shape[-1]
    x = torch.empty_like(rhs)
    err = _cuda.lib().trajopt_chol_solve(
        l.data_ptr(), rhs.data_ptr(), x.data_ptr(), batch, m, nrhs, _cuda.stream()
    )
    _cuda.check_launch(err, "chol_solve")
    return x
