"""Unrolled batched Cholesky and triangular solves for tiny blocks.

Port of `trajopt_tpu/ops/smallchol.py`: the same column-by-column
recurrences, written as torch ops over leading batch axes.  These are the
plain versions of kernels K3 (`mod_cholesky`, `cholesky`) and K4
(`cho_solve`), see `ops/cuda_chol.py`.  An indefinite input to `cholesky`
yields NaNs in the factor.
"""

from __future__ import annotations

import math

import torch


def mod_cholesky(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GMW81-style modified Cholesky.

    a: [..., m, m] -> (l lower with ``l @ l.T == a + diag(e)``, PD by
    construction; e [..., m] diagonal boosts, 0 on comfortably-PD input).
    The thresholds use the fixed eps = 1.19e-7 in every dtype.
    """
    m = a.shape[-1]
    eps = 1.19e-7
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    gamma = diag.abs().amax(dim=-1)
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    offmax = (a - diag[..., None] * eye).abs().amax(dim=(-1, -2))
    nf = max(math.sqrt(m * m - 1), 1.0)
    beta2 = torch.clamp(torch.maximum(gamma, offmax / nf), min=eps)
    delta = eps * torch.clamp(gamma + offmax, min=1.0)

    cols, es = [], []
    for j in range(m):
        dorig = a[..., 0, 0]
        below = a[..., 1:, 0]
        theta = below.abs().amax(dim=-1) if below.shape[-1] else torch.zeros_like(dorig)
        dnew = torch.maximum(torch.maximum(dorig.abs(), theta * theta / beta2), delta)
        es.append(dnew - dorig)
        piv = torch.sqrt(dnew)
        col = torch.cat([piv[..., None], below / piv[..., None]], dim=-1)
        if j < m - 1:
            rest = col[..., 1:]
            a = a[..., 1:, 1:] - rest[..., :, None] * rest[..., None, :]
        if j:
            col = torch.cat([col.new_zeros(col.shape[:-1] + (j,)), col], dim=-1)
        cols.append(col)
    return torch.stack(cols, dim=-1), torch.stack(es, dim=-1)


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of [..., m, m] PD blocks (NaN if not PD)."""
    m = a.shape[-1]
    cols = []
    for j in range(m):
        piv = torch.sqrt(a[..., 0, 0])
        col = a[..., :, 0] / piv[..., None]
        if j < m - 1:
            rest = col[..., 1:]
            a = a[..., 1:, 1:] - rest[..., :, None] * rest[..., None, :]
        if j:
            col = torch.cat([col.new_zeros(col.shape[:-1] + (j,)), col], dim=-1)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L y = b; b is [..., m] or [..., m, k]."""
    vec = b.ndim == l.ndim - 1
    if vec:
        b = b[..., None]
    m = l.shape[-1]
    ys = []
    for i in range(m):
        acc = b[..., i, :]
        if i:
            stacked = torch.stack(ys, dim=-1)              # [..., k, i]
            acc = acc - torch.einsum("...ki,...i->...k", stacked, l[..., i, :i])
        ys.append(acc / l[..., i, i][..., None])
    y = torch.stack(ys, dim=-2)
    return y[..., 0] if vec else y


def solve_upper_t(l: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Back substitution L^T x = y."""
    vec = y.ndim == l.ndim - 1
    if vec:
        y = y[..., None]
    m = l.shape[-1]
    xs_rev = []
    for i in range(m - 1, -1, -1):
        acc = y[..., i, :]
        if xs_rev:
            stacked = torch.stack(xs_rev[::-1], dim=-1)    # [..., k, m-1-i]
            acc = acc - torch.einsum("...ki,...i->...k", stacked, l[..., i + 1 :, i])
        xs_rev.append(acc / l[..., i, i][..., None])
    x = torch.stack(xs_rev[::-1], dim=-2)
    return x[..., 0] if vec else x


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the Cholesky factor L of A."""
    return solve_upper_t(l, solve_lower(l, b))


def solve_pd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for PD A."""
    return cho_solve(cholesky(a), b)
