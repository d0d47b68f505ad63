"""Plain versions of the hand-written kernels, on any device.

Copied from `trajopt_tpu_torch/ops/cuda_topk.py` (K1), `cuda_gjk.py` (K2),
`cuda_chol.py` (K3, K4 and their fused launch) and `cuda_eig.py` (K6) as of
commit 35ea473: the functions those wrappers take for a CPU tensor.  Here
every call takes them, so the reference runs in whatever dtype and on
whatever device its inputs are.
"""

from __future__ import annotations

import torch

from . import geometry as geo
from . import smallchol as sc


def smallest_k_plain(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries along the last axis: (vals [..., k], idx [..., k])."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def smallest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"smallest_k needs 0 < k <= n, got k={k}, n={n}")
    return smallest_k_plain(x, k)


def gjk_exact(u: torch.Tensor, iters: int) -> geo.HullDist:
    """Distance from the origin to conv(u[i]) for u [N, m, 3]."""
    if u.ndim != 3 or u.shape[-1] != 3 or u.shape[1] < 1:
        raise ValueError(f"gjk_exact expects [N, m, 3], got {tuple(u.shape)}")
    return geo.origin_simplex_dist(u, iters)


def _mod_chol_plain(h: torch.Tensor, gmw: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    if gmw:
        return sc.mod_cholesky(h)
    return sc.cholesky(h), h.new_zeros(h.shape[:-1])


def mod_chol(h: torch.Tensor, gmw: bool = True, want_l: bool = True):
    """(l, e) with L L^T = h + diag(e); l is None with ``want_l=False``."""
    l, e = _mod_chol_plain(h, gmw)
    return (l if want_l else None), e


def chol_solve(l: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return sc.cho_solve(l, rhs)


def factor_solve(h: torch.Tensor, rhs: torch.Tensor, gmw: bool = True, want_l: bool = True):
    """`mod_chol` then `chol_solve`: (l, e, x)."""
    l, e = _mod_chol_plain(h, gmw)
    return (l if want_l else None), e, sc.cho_solve(l, rhs)


def eigvalsh(h: torch.Tensor) -> torch.Tensor:
    if h.ndim < 2 or h.shape[-2] != h.shape[-1]:
        raise ValueError(f"eigvalsh expects [..., m, m], got {tuple(h.shape)}")
    return torch.linalg.eigvalsh(h)
