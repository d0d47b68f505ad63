"""PyTorch/CUDA port of the consensus-ADMM trajectory optimizer.

Mirrors the layout of `trajopt_tpu` (``types``, ``ops``, ``solver``,
``cli``) and imports nothing of it: the host-side NumPy modules (config,
spline operator builders, scene generators, metrics, plots) are the port's
own copies; everything that runs per iteration is torch.  The kernels that
`trajopt_tpu` writes in Pallas are hand-written CUDA C++ here
(``csrc/*.cu``), each with a plain torch version beside its wrapper.
"""

from .config import TrajOptConfig

__all__ = ["TrajOptConfig"]
