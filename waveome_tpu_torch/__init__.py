"""waveome_tpu_torch — the penalized Gaussian GP fit in PyTorch, for NVIDIA
Hopper GPUs.

The PyTorch counterpart of ``waveome_tpu`` (the JAX reference package).
Module paths mirror the reference one to one (``kernels/gram.py`` ↔
``kernels/gram.py`` and so on); the Pallas TPU kernels are hand-written
CUDA kernels in ``csrc/`` behind ``cuda_ops/``.

Covered: the horseshoe-penalized Gaussian fit
(``fit.fit_outcomes_penalized``) from data to pruned masks and
importances, with all data as inducing points or M < N trained inducing
points, and the automatic penalization factor re-estimated as the
reference does. Tensors on the CPU run each kernel's plain PyTorch
version; tensors on a CUDA device run the kernels. This package never
imports ``jax``, ``waveome_tpu``, ``bench`` or ``pandas``.
"""

from .config import default_float, default_jitter, get_precision, set_precision
from .kernels import KernelSpec, Primitive, full_kernel_build

__all__ = [
    "KernelSpec",
    "Primitive",
    "default_float",
    "default_jitter",
    "full_kernel_build",
    "get_precision",
    "set_precision",
]
