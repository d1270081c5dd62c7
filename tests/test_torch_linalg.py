"""The port's Cholesky (CholeskyFn: cholesky_ex on the CPU, kernel K2 on
the GPU; Murray pullback backward) against waveome_tpu.linalg, and the
hybrid blocked Cholesky with its diagonal-block factor (kernel K3 on the
GPU, diag_factor_plain on the CPU) against waveome_tpu's Pallas hybrid in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, t64

from waveome_tpu.linalg import _blocked_cholesky_bwd, blocked_cholesky
from waveome_tpu.pallas_ops import chol_pallas
from waveome_tpu_torch.cuda_ops import diag_factor_cuda
from waveome_tpu_torch.cuda_ops.chol_cuda import cholesky_plain
from waveome_tpu_torch.linalg import (
    cholesky,
    cholesky_hybrid,
    cholesky_pullback,
    hybrid_supported,
)


def _spd_batch(N, B=3, noise=0.05, seed=0):
    """RBF grams + σ²I, ill-conditioned at small σ² (the fit's regime)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.normal(size=N))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.3 ** 2)
    return np.stack([K + (noise + 0.1 * i) * np.eye(N) for i in range(B)])


@pytest.mark.parametrize("N", [1, 17, 130])
def test_cholesky_matches_reference(N):
    A = _spd_batch(N)
    L = cholesky(t64(A))
    assert_close(L, jnp.linalg.cholesky(jnp.asarray(A)), atol=1e-12)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))


def test_cholesky_gradient_matches_blocked_pullback():
    """CholeskyFn's backward against jax.vjp of linalg.blocked_cholesky
    (the reference's custom pullback) for a random cotangent; the
    cotangent's upper triangle is ignored by both."""
    A = _spd_batch(40, B=2, noise=0.1)
    Lbar = np.random.default_rng(1).normal(size=A.shape)
    _, vjp = jax.vjp(jax.vmap(blocked_cholesky), jnp.asarray(A))
    (want,) = vjp(jnp.asarray(np.tril(Lbar)))
    a = t64(A).requires_grad_(True)
    (cholesky(a) * t64(np.tril(Lbar))).sum().backward()
    assert_close(a.grad, want, rtol=1e-8, atol=1e-10)  # cond(A) ~ 1e3
    L = jnp.linalg.cholesky(jnp.asarray(A))
    (direct,) = _blocked_cholesky_bwd(L, jnp.asarray(np.tril(Lbar)))
    assert_close(cholesky_pullback(t64(L), t64(np.tril(Lbar))), direct,
                 atol=1e-10)


def test_logdet_gradient_is_the_inverse():
    A = _spd_batch(25, B=2, noise=0.3)
    a = t64(A).requires_grad_(True)
    L = cholesky(a)
    (2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1))).sum().backward()
    assert_close(a.grad, np.linalg.inv(A), rtol=1e-9, atol=1e-12)


def test_nan_on_non_positive_definite_without_raising():
    A = _spd_batch(12, B=3)
    A[1] -= 3.0 * np.eye(12)  # indefinite
    L = cholesky(t64(A))
    assert torch.isnan(L[1]).all()
    assert torch.isfinite(L[0]).all() and torch.isfinite(L[2]).all()
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    # the reference's lower triangle is NaN too
    assert np.isnan(want[1][np.tril_indices(12)]).all()
    assert torch.isnan(cholesky_plain(t64(A))[1]).all()


def _random_spd(B, N, seed):
    """The reference's own test matrices (tests/test_pallas_chol.py)."""
    A = np.random.default_rng(seed).normal(size=(B, N, N))
    return A @ np.swapaxes(A, -1, -2) + N * np.eye(N)


def test_diag_factor_plain_matches_pallas_interpret():
    """(L11, L11⁻¹) of 8×8 blocks against the Pallas body in interpret
    mode: the plain version solves where the kernel substitutes, so they
    agree to float64 rounding."""
    D = _random_spd(5, 8, seed=5)
    L, Linv = diag_factor_cuda.diag_factor_plain(t64(D))
    want_L, want_inv = chol_pallas._diag_factor(jnp.asarray(D),
                                                interpret=True)
    assert_close(L, want_L, atol=1e-13)
    assert_close(Linv, want_inv, atol=1e-13)
    assert torch.equal(torch.triu(Linv, 1), torch.zeros_like(Linv))
    L2, _ = diag_factor_cuda.diag_factor(t64(D))  # CPU: the plain version
    assert torch.equal(L2, L)


def test_cholesky_hybrid_matches_pallas_hybrid():
    """B = 2, N = 20 at blk = 8 (pads to 24, three block steps), as
    tests/test_pallas_chol.py runs the reference; within 1e-5 of max|L|
    of the interpret-mode Pallas hybrid, and of cholesky_ex."""
    K = _random_spd(2, 20, seed=3)
    L = cholesky_hybrid(t64(K), blk=8)
    want = np.asarray(chol_pallas.cholesky_hybrid(
        jnp.asarray(K), diag_impl="pallas", interpret=True, blk=8))
    scale = np.abs(want).max()
    assert np.abs(L.numpy() - want).max() < 1e-5 * scale
    assert np.abs(L.numpy() - np.linalg.cholesky(K)).max() < 1e-5 * scale
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    # a single matrix and a nested batch go through the same blocks
    assert_close(cholesky_hybrid(t64(K[0]), blk=8), L[0].numpy())
    assert cholesky_hybrid(t64(K).reshape(2, 1, 20, 20), blk=8).shape == (
        2, 1, 20, 20)


def test_hybrid_supported_bounds():
    assert hybrid_supported(48) and hybrid_supported(500)
    assert hybrid_supported(2048)
    assert not hybrid_supported(47) and not hybrid_supported(2049)
    for n in (47, 48, 500, 2048, 2049):
        assert hybrid_supported(n) == chol_pallas.hybrid_supported(n)
