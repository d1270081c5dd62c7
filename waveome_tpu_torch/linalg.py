"""Cholesky with the stable closed-form pullback (counterpart of
``waveome_tpu/linalg.py``).

The forward is kernel K2 on CUDA tensors and ``cholesky_ex`` on CPU
tensors (``cuda_ops.chol_cuda.cholesky_forward``); the backward is the
Murray (2016) Cholesky pullback, as in the reference's
``_blocked_cholesky_bwd``:
    P = Φ(Lᵀ L̄),  Ā = L⁻ᵀ (P + Pᵀ)/2 L⁻¹,
with Φ = tril with halved diagonal — two triangular solves and a product.

``cholesky_hybrid`` is the counterpart of the reference's lane-batched
hybrid (``waveome_tpu/pallas_ops/chol_pallas.py:cholesky_hybrid``): a
blocked factorization whose diagonal blocks go through kernel K3 and whose
panels are solved against K3's explicit inverse. Forward only, and only
for the line search's trials under ``hybrid_trial_cholesky``.
"""

from __future__ import annotations

import torch

from .cuda_ops.chol_cuda import cholesky_forward
from .cuda_ops.diag_factor_cuda import NB as HBLK
from .cuda_ops.diag_factor_cuda import diag_factor


def cholesky_pullback(L: torch.Tensor, Lbar: torch.Tensor) -> torch.Tensor:
    """Ā for L = chol(A), given L̄ = ∂f/∂L."""
    Lt = L.transpose(-1, -2)
    M = Lt @ Lbar
    P = torch.tril(M, -1) + 0.5 * torch.diag_embed(
        torch.diagonal(M, dim1=-2, dim2=-1))
    S = 0.5 * (P + P.transpose(-1, -2))
    X = torch.linalg.solve_triangular(Lt, S, upper=True)
    Abar = torch.linalg.solve_triangular(Lt, X.transpose(-1, -2), upper=True)
    return Abar.transpose(-1, -2)


class CholeskyFn(torch.autograd.Function):
    """Lower Cholesky: forward K2 (CUDA) or ``cholesky_ex`` (CPU), NaN
    for a matrix that is not positive definite; backward the Murray
    pullback."""

    @staticmethod
    def forward(ctx, A):
        L = cholesky_forward(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return cholesky_pullback(L, Lbar)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., N, N), differentiable."""
    return CholeskyFn.apply(K)


def hybrid_supported(N: int) -> bool:
    """The sizes the reference's hybrid takes: N ≥ one block, N ≤ 2048."""
    return HBLK <= N <= 2048


def cholesky_hybrid(A: torch.Tensor, blk: int = HBLK,
                    refine: int = 1) -> torch.Tensor:
    """Lower Cholesky of (..., N, N) by blocks of ``blk``: N is padded to a
    multiple of ``blk`` with an identity block; at each block step K3
    (``diag_factor``) reads the diagonal block of the padded copy and
    writes L11 into the factor in place, L11⁻¹ into a buffer; the panel
    is P = A21·L11⁻ᵀ plus ``refine`` rounds of P += (A21 − P·L11ᵀ)·L11⁻ᵀ,
    and the trailing matrix takes A22 −= P·Pᵀ (batched GEMMs, updated in
    place on a padded copy). CUDA tensors need ``blk`` = 48, K3's size;
    CPU tensors take any ``blk`` (the tests shrink it).

    The explicit-inverse panel solve amplifies rounding by cond(L11): the
    reference measured it corrupting real fit grams (K + σ²I with small
    σ²), so this stays an opt-in for the line-search trials.
    """
    batch = A.shape[:-2]
    N = A.shape[-1]
    A3 = A.reshape(-1, N, N)
    Np = N + (-N) % blk
    W = A3.new_zeros((A3.shape[0], Np, Np))
    W[:, :N, :N] = A3
    W[:, N:, N:] = torch.eye(Np - N, dtype=A.dtype, device=A.device)
    L = torch.zeros_like(W)
    inv11 = W.new_empty((W.shape[0], blk, blk))
    for o in range(0, Np, blk):
        e = o + blk
        L11, _ = diag_factor(W[:, o:e, o:e], L[:, o:e, o:e], inv11)
        if e == Np:
            break
        A21 = W[:, e:, o:e]
        inv11t = inv11.transpose(-1, -2)
        P = A21 @ inv11t
        for _ in range(refine):
            P = P + (A21 - P @ L11.transpose(-1, -2)) @ inv11t
        L[:, e:, o:e] = P
        W[:, e:, e:].baddbmm_(P, P.transpose(-1, -2), alpha=-1.0)
    return L[:, :N, :N].reshape(batch + (N, N))
