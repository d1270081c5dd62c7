"""Kernel K3, the batched factor and inverse of 48×48 diagonal blocks
(counterpart of ``waveome_tpu/pallas_ops/chol_pallas.py``:
``_diag_factor_impl``, body ``_diag_factor_body``).

``diag_factor_cuda`` launches ``csrc/diag_factor.cu`` on a (B, 48, 48)
float32 batch, reading from and writing to strided views (each a view whose
last dimension has stride 1, such as the diagonal blocks of a larger
matrix); ``diag_factor_plain`` is its plain PyTorch version, the
reference's own A/B path ``_diag_factor_xla``: ``cholesky_ex`` followed by
a triangular solve against I. ``diag_factor`` picks by device: K3 for CUDA
tensors, the plain version for CPU tensors. Both return (L11, L11⁻¹) with
zero upper triangles. They differ on a block that is not positive
definite: K3 clamps its pivots at 1e-30 as the Pallas body does, the plain
version returns what ``cholesky_ex`` leaves. ``diag_factor_steps_plain``
states the kernel's own recurrence in PyTorch (rsqrt of the clamped pivot,
a right-looking factor, a column-oriented inverse by reciprocals), so that
its arithmetic can be tested without the card.
"""

from __future__ import annotations

import torch

from . import _lib

# The block size K3 is built for (the reference's HBLK).
NB = 48
# Launches of K3 since the last reset (read by chip_smoke.py).
launch_count = 0
# The pivot clamp of the Pallas body (chol_pallas.py:186, :202).
PIVOT_FLOOR = 1e-30


def _check_view(name: str, T: torch.Tensor, B: int, device) -> None:
    if T.device != device:
        raise ValueError(f"diag_factor_cuda: {name} is on {T.device}, "
                         f"not {device}")
    if T.dtype != torch.float32:
        raise TypeError(f"diag_factor_cuda takes float32 only, {name} is "
                        f"{T.dtype}")
    if tuple(T.shape) != (B, NB, NB):
        raise ValueError(f"diag_factor_cuda: {name} has shape "
                         f"{tuple(T.shape)}, expected ({B}, {NB}, {NB})")
    if T.stride(2) != 1 or T.stride(1) < NB:
        raise ValueError(f"diag_factor_cuda: {name} has strides "
                         f"{T.stride()}; K3 takes views whose rows are "
                         f"contiguous and do not overlap")


def diag_factor_cuda(D: torch.Tensor, L: torch.Tensor | None = None,
                     Linv: torch.Tensor | None = None):
    """(L11, L11⁻¹) of a (B, 48, 48) float32 CUDA batch; only the lower
    triangle of D is read. D, and the outputs ``L`` and ``Linv`` when given
    (else they are allocated), may be any views whose last dimension has
    stride 1 and whose rows do not overlap; the outputs must not overlap D.
    Any other view raises: nothing is copied."""
    global launch_count
    if D.device.type != "cuda":
        raise ValueError(f"diag_factor_cuda needs a CUDA tensor, got "
                         f"{D.device}")
    if D.dim() != 3:
        raise ValueError(f"diag_factor_cuda: shape {tuple(D.shape)}, "
                         f"expected (B, {NB}, {NB})")
    B = D.shape[0]
    L = torch.empty_like(D, memory_format=torch.contiguous_format) \
        if L is None else L
    Linv = torch.empty_like(D, memory_format=torch.contiguous_format) \
        if Linv is None else Linv
    for name, T in (("D", D), ("L", L), ("Linv", Linv)):
        _check_view(name, T, B, D.device)
    lib = _lib.library()
    if lib.waveome_diag_factor_nb() != NB:
        raise RuntimeError("diag_factor_cuda: the built kernel's block size "
                           f"is {lib.waveome_diag_factor_nb()}, not {NB}")
    if B == 0:
        return L, Linv
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        if D.is_contiguous() and L.is_contiguous() and Linv.is_contiguous():
            rc = lib.waveome_diag_factor_forward(
                D.data_ptr(), L.data_ptr(), Linv.data_ptr(), B, stream)
        else:
            rc = lib.waveome_diag_factor_strided(
                D.data_ptr(), D.stride(1), D.stride(0), L.data_ptr(),
                L.stride(1), L.stride(0), Linv.data_ptr(), Linv.stride(1),
                Linv.stride(0), B, stream)
    _lib.check(rc, "waveome_diag_factor")
    launch_count += 1
    return L, Linv


def diag_factor_plain(D: torch.Tensor):
    """Plain PyTorch version: (L, L⁻¹) of a (B, n, n) batch by
    ``cholesky_ex`` and a triangular solve against I."""
    L, _ = torch.linalg.cholesky_ex(D)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    return L, torch.linalg.solve_triangular(L, eye.expand(D.shape),
                                            upper=False)


def diag_factor_steps_plain(D: torch.Tensor):
    """K3's recurrence in PyTorch on (..., n, n): for each column j the
    pivot p = A[j][j], L[:, j] = A[:, j]·rsqrt(max(p, 1e-30)) on and below
    the diagonal, 1/max(L[j][j], 1e-30) kept, and the trailing lower
    triangle loses L[:, j] L[:, j]ᵀ; then L⁻¹ column-oriented: row k of X
    (from X = I) is scaled by that reciprocal and rows m > k lose
    L[m][k]·X[k]. Only the lower triangle of D is read."""
    n = D.shape[-1]
    A = torch.tril(D)
    L = torch.zeros_like(D)
    rinv = torch.zeros(D.shape[:-1], dtype=D.dtype, device=D.device)
    for j in range(n):
        pv = A[..., j, j]
        rs = torch.rsqrt(pv.clamp(min=PIVOT_FLOOR))
        col = A[..., j:, j] * rs[..., None]
        L[..., j:, j] = col
        rinv[..., j] = 1.0 / (pv * rs).clamp(min=PIVOT_FLOOR)
        A[..., j + 1:, j + 1:] -= torch.tril(col[..., 1:, None]
                                             * col[..., None, 1:])
    X = torch.eye(n, dtype=D.dtype, device=D.device).expand(D.shape).clone()
    for k in range(n):
        X[..., k, :] *= rinv[..., k, None]
        X[..., k + 1:, :] -= L[..., k + 1:, k, None] * X[..., k, None, :]
    return L, torch.tril(X)


def diag_factor(D: torch.Tensor, L: torch.Tensor | None = None,
                Linv: torch.Tensor | None = None):
    """(L11, L11⁻¹) of (B, n, n): K3 for CUDA tensors (n = 48, views as
    ``diag_factor_cuda`` takes them), the plain version for CPU tensors
    (any n, as the reference's tests shrink the block). ``L`` and ``Linv``,
    when given, are written and returned."""
    if D.device.type != "cpu":
        return diag_factor_cuda(D, L, Linv)
    L11, inv11 = diag_factor_plain(D)
    if L is not None:
        L11 = L.copy_(L11)
    if Linv is not None:
        inv11 = Linv.copy_(inv11)
    return L11, inv11
