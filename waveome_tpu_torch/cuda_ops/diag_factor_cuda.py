"""Kernel K3, the batched factor and inverse of 48×48 diagonal blocks
(counterpart of ``waveome_tpu/pallas_ops/chol_pallas.py``:
``_diag_factor_impl``, body ``_diag_factor_body``).

``diag_factor_cuda`` launches ``csrc/diag_factor.cu`` on a (B, 48, 48)
float32 batch; ``diag_factor_plain`` is its plain PyTorch version, the
reference's own A/B path ``_diag_factor_xla``: ``cholesky_ex`` followed by
a triangular solve against I. ``diag_factor`` picks by device: K3 for CUDA
tensors, the plain version for CPU tensors. Both return (L11, L11⁻¹) with
zero upper triangles. They differ on a block that is not positive
definite: K3 clamps its pivots at 1e-30 as the Pallas body does, the plain
version returns what ``cholesky_ex`` leaves.
"""

from __future__ import annotations

import torch

from . import _lib

# The block size K3 is built for (the reference's HBLK).
NB = 48
# Launches of K3 since the last reset (read by chip_smoke.py).
launch_count = 0


def diag_factor_cuda(D: torch.Tensor):
    """(L11, L11⁻¹) of a contiguous (B, 48, 48) float32 CUDA batch; only
    the lower triangle of D is read."""
    global launch_count
    if D.device.type != "cuda":
        raise ValueError(f"diag_factor_cuda needs a CUDA tensor, got "
                         f"{D.device}")
    if D.dtype != torch.float32:
        raise TypeError(f"diag_factor_cuda takes float32 only, got {D.dtype}")
    if D.dim() != 3 or tuple(D.shape[1:]) != (NB, NB):
        raise ValueError(f"diag_factor_cuda: shape {tuple(D.shape)}, "
                         f"expected (B, {NB}, {NB})")
    if not D.is_contiguous():
        raise ValueError("diag_factor_cuda: D is not contiguous")
    lib = _lib.library()
    if lib.waveome_diag_factor_nb() != NB:
        raise RuntimeError("diag_factor_cuda: the built kernel's block size "
                           f"is {lib.waveome_diag_factor_nb()}, not {NB}")
    L = torch.empty_like(D)
    Linv = torch.empty_like(D)
    if D.shape[0] == 0:
        return L, Linv
    with torch.cuda.device(D.device):
        rc = lib.waveome_diag_factor_forward(
            D.data_ptr(), L.data_ptr(), Linv.data_ptr(), D.shape[0],
            torch.cuda.current_stream(D.device).cuda_stream)
    _lib.check(rc, "waveome_diag_factor_forward")
    launch_count += 1
    return L, Linv


def diag_factor_plain(D: torch.Tensor):
    """Plain PyTorch version: (L, L⁻¹) of a (B, n, n) batch by
    ``cholesky_ex`` and a triangular solve against I."""
    L, _ = torch.linalg.cholesky_ex(D)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    return L, torch.linalg.solve_triangular(L, eye.expand(D.shape),
                                            upper=False)


def diag_factor(D: torch.Tensor):
    """(L11, L11⁻¹) of (B, n, n): K3 for CUDA tensors (n = 48), the plain
    version for CPU tensors (any n, as the reference's tests shrink the
    block)."""
    if D.device.type == "cpu":
        return diag_factor_plain(D)
    return diag_factor_cuda(D.contiguous())
