"""PyTorch/CUDA port of the consensus-ADMM trajectory optimizer.

Mirrors the layout of `trajopt_tpu` (``types``, ``ops``, ``solver``,
``cli``).  The host-side NumPy modules of `trajopt_tpu` (config, spline
operator builders, scene generators, metrics) import no JAX and are used
as they are; everything that runs per iteration is torch.  The kernels that
`trajopt_tpu` writes in Pallas are hand-written CUDA C++ here
(``csrc/*.cu``), each with a plain torch version beside its wrapper.
"""

from trajopt_tpu.config import TrajOptConfig

__all__ = ["TrajOptConfig"]
