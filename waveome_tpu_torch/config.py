"""Precision switch and Cholesky jitter (counterpart of ``waveome_tpu/config.py``).

float32 is the default working precision on the GPU; float64 is the parity
mode the CPU tests run in. Unlike the JAX package, the precision is not a
process-wide mode: every function computes in the dtype of the tensors it
is given, and ``default_float`` only picks the dtype of new parameters.
"""

from __future__ import annotations

from typing import Optional

import torch

# Full-precision float32 products everywhere. Lower-precision products in
# the Cholesky's Schur complement made L-BFGS stop early in the reference
# (waveome_tpu/linalg.py: the "HIGHEST matmul precision" note).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DEFAULT_FLOAT = torch.float32


def set_precision(precision: str = "float32") -> None:
    """Set the dtype of newly created parameters ("float32" or "float64")."""
    global _DEFAULT_FLOAT
    if precision not in ("float32", "float64"):
        raise ValueError("Precision must be either 'float32' or 'float64'")
    _DEFAULT_FLOAT = torch.float64 if precision == "float64" else torch.float32


def get_precision() -> str:
    return "float64" if _DEFAULT_FLOAT == torch.float64 else "float32"


def default_float() -> torch.dtype:
    return _DEFAULT_FLOAT


def resolve_device(device, caller: str) -> torch.device:
    """The caller's device, else the CUDA device; without CUDA this raises
    instead of falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{caller} runs on CUDA unless a device is "
                           f"given, and no CUDA device is available; pass "
                           f"device='cpu' for the CPU")
    return torch.device("cuda")


def default_jitter(dtype: Optional[torch.dtype] = None) -> float:
    """Cholesky jitter: 1e-6 in float64 (the GPflow default), 1e-4 in
    float32, where batched factorizations need a larger floor."""
    dtype = dtype or _DEFAULT_FLOAT
    return 1e-6 if dtype == torch.float64 else 1e-4
