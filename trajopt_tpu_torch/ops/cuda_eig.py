"""K6: batched eigenvalues of small symmetric blocks.

Replaces XLA's `jnp.linalg.eigvalsh` in
`trajopt_tpu/ops/gradients.py::psd_repair` (the ``psd_method="eigh"``
shift; no Pallas site in the JAX package).  The CUDA kernel is
``csrc/eig.cu``: parallel cyclic Jacobi, one warp per block, so m <= 32
(the solver's blocks are 19 x 19).  Unlike `torch.linalg.eigvalsh` on the
card, it reads nothing back to the host, so a CUDA graph can hold it.

Plain version: `torch.linalg.eigvalsh`, the function the JAX package
calls; on the CPU in float64 it keeps the port's eigenvalue shift to
round-off of the JAX package's.
"""

from __future__ import annotations

import torch

from . import _cuda

MAX_M = 32   # one lane a row of the block


def eigvalsh_plain(h: torch.Tensor) -> torch.Tensor:
    return torch.linalg.eigvalsh(h)


def eigvalsh(h: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric blocks h [..., m, m] (the lower triangle is
    read), ascending: w [..., m].  A block with a non-finite entry gives
    NaN throughout.

    CPU tensors take `eigvalsh_plain`; CUDA tensors launch K6 (float32,
    contiguous, m <= 32) or raise."""
    if h.ndim < 2 or h.shape[-2] != h.shape[-1]:
        raise ValueError(f"eigvalsh expects [..., m, m], got {tuple(h.shape)}")
    if h.device.type == "cpu":
        return eigvalsh_plain(h)
    m = h.shape[-1]
    if m > MAX_M:
        raise ValueError(f"the eigenvalue kernel takes m <= {MAX_M}, got {m}")
    _cuda.require_cuda_f32("eigvalsh", h)
    w = torch.empty(h.shape[:-1], dtype=h.dtype, device=h.device)
    batch = h.numel() // (m * m) if m else 0
    if batch == 0:
        return w
    err = _cuda.lib().trajopt_eigvalsh(h.data_ptr(), w.data_ptr(), batch, m, _cuda.stream())
    _cuda.check_launch(err, "eigvalsh", (h.shape, "m", m))
    return w
