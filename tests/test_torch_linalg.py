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


def _non_pd_last_pivot(D):
    """D with its last pivot pushed below zero: the factor's clamp at 1e-30
    takes over at the last column only, so the values stay finite."""
    D = D.copy()
    n = D.shape[-1]
    D[:, n - 1, n - 1] -= 2.0 * np.linalg.eigvalsh(D)[:, -1]
    return D


@pytest.mark.parametrize("case", ["spd", "non_pd"])
def test_diag_factor_steps_plain_matches_pallas_interpret(case):
    """K3's recurrence (rsqrt of the clamped pivot, column-oriented inverse
    by reciprocals) against the Pallas body in interpret mode on 8×8
    blocks in float64, also where the clamp acts (the last pivot below
    zero: L[7][7] = pivot·1e15, L⁻¹'s last row ·1e30): relative to each
    output's largest entry, float64 rounding."""
    D = _random_spd(5, 8, seed=7)
    if case == "non_pd":
        D = _non_pd_last_pivot(D)
    L, Linv = diag_factor_cuda.diag_factor_steps_plain(t64(D))
    want_L, want_inv = (np.asarray(x) for x in chol_pallas._diag_factor(
        jnp.asarray(D), interpret=True))
    assert np.isfinite(want_L).all() and np.isfinite(want_inv).all()
    for got, want in ((L, want_L), (Linv, want_inv)):
        assert torch.isfinite(got).all()
        assert np.abs(got.numpy() - want).max() < 1e-12 * np.abs(want).max()
        assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    if case == "non_pd":
        assert (L[:, 7, 7] < -1e13).all() and Linv.abs().max() > 1e28


def test_diag_factor_steps_plain_matches_plain_float32():
    """At K3's size and type, 48×48 float32 (RBF diagonal blocks at
    σ² ∈ {0.05, 1} and the reference's random SPD blocks): within 1e-4 of
    max|L| and max|L⁻¹| of diag_factor_plain (cholesky_ex + solve), the
    tolerance the kernel is held to on the card; L·L⁻¹ = I within 1e-4."""
    D = np.concatenate([_spd_batch(48, B=2, noise=0.05),
                        _spd_batch(48, B=2, noise=1.0),
                        _random_spd(3, 48, seed=11)])
    D32 = torch.tensor(D, dtype=torch.float32)
    L, Linv = diag_factor_cuda.diag_factor_steps_plain(D32)
    L_ref, Linv_ref = diag_factor_cuda.diag_factor_plain(D32)
    assert (L - L_ref).abs().max() < 1e-4 * L_ref.abs().max()
    assert (Linv - Linv_ref).abs().max() < 1e-4 * Linv_ref.abs().max()
    assert (L @ Linv - torch.eye(48)).abs().max() < 1e-4
    # only the lower triangle is read
    L2, Linv2 = diag_factor_cuda.diag_factor_steps_plain(
        torch.tril(D32) + 5.0 * torch.triu(torch.ones_like(D32), 1))
    assert torch.equal(L2, L) and torch.equal(Linv2, Linv)


def test_diag_factor_steps_plain_non_pd_is_finite():
    """A 48×48 float32 block whose last pivot is below zero: finite, the
    last diagonal entry pivot·1e15 as the clamp gives it, the other columns
    those of the leading 47×47 block's factor."""
    D = _non_pd_last_pivot(_random_spd(2, 48, seed=13))
    D32 = torch.tensor(D, dtype=torch.float32)
    L, Linv = diag_factor_cuda.diag_factor_steps_plain(D32)
    assert torch.isfinite(L).all() and torch.isfinite(Linv).all()
    assert (L[:, 47, 47] < -1e13).all()
    L47, _ = diag_factor_cuda.diag_factor_plain(D32[:, :47, :47])
    assert (L[:, :47, :47] - L47).abs().max() < 1e-4 * L47.abs().max()


def test_diag_factor_writes_into_given_views():
    """On the CPU, ``diag_factor`` with output views (as cholesky_hybrid
    passes its factor's diagonal blocks) writes them and returns them."""
    W = torch.tensor(_random_spd(2, 16, seed=2))
    out = torch.zeros(2, 24, 24, dtype=torch.float64)
    inv = torch.empty(2, 8, 8, dtype=torch.float64)
    L11, inv11 = diag_factor_cuda.diag_factor(W[:, 8:, 8:], out[:, 8:16, 8:16],
                                              inv)
    want_L, want_inv = diag_factor_cuda.diag_factor_plain(W[:, 8:, 8:])
    assert L11.data_ptr() == out[:, 8:16, 8:16].data_ptr()
    assert inv11.data_ptr() == inv.data_ptr()
    assert torch.equal(L11, want_L) and torch.equal(inv11, want_inv)
    assert out[:, :8].abs().max() == 0 and out[:, 16:].abs().max() == 0


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


# ---------------------------------------------------------------------------
# K2's algorithm step by step (cholesky_blocked_plain): diagonal block, row
# solves, trailing update, with plain products and with three TF32 passes
# ---------------------------------------------------------------------------

def _low_rank_kuu(N, seed=0):
    """Kuu + 1e-4 I of a kernel whose rank is far below N (a categorical
    kernel on 3 levels plus a smooth SE): jitter sets the small pivots, as
    on the sparse path."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, N)
    t = np.sort(rng.uniform(0, 1, N))
    K = 2.0 * (g[:, None] == g[None, :]) \
        + 3.0 * np.exp(-0.5 * (t[:, None] - t[None, :]) ** 2 / 2.0 ** 2)
    return (K + 1e-4 * np.eye(N))[None]


_BLOCKED_CASES = {
    "rbf_0.05": lambda N: _spd_batch(N, B=2, noise=0.05),
    "rbf_1": lambda N: _spd_batch(N, B=2, noise=1.0),
    "kuu": _low_rank_kuu,
}


@pytest.mark.parametrize("tf32x3", [False, True])
@pytest.mark.parametrize("nb", [8, 32])
@pytest.mark.parametrize("N", [1, 31, 33, 100])
@pytest.mark.parametrize("case", sorted(_BLOCKED_CASES))
def test_cholesky_blocked_plain_against_float64(case, N, nb, tf32x3):
    """float32 through the kernel's algorithm against a float64
    factorization of the same float32 matrices: residual within 5e-5
    (~N eps for a stable factorization) and log-determinant within 1e-5
    relative (the gates K2 is held to on the card). On the low-rank Kuu
    (condition number 1e6 to 4e6) the smallest pivots carry cond·eps ~ 0.1
    of relative error in float32 whatever the algorithm (cholesky_ex is
    1.4e-4 off at N = 33), so its log-determinant gate is 1e-3."""
    from waveome_tpu_torch.cuda_ops.chol_cuda import cholesky_blocked_plain
    A = torch.tensor(_BLOCKED_CASES[case](N), dtype=torch.float32)
    A64 = A.double()
    L = cholesky_blocked_plain(A, nb, tf32x3=tf32x3)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    Ld = L.double()
    resid = torch.linalg.matrix_norm(Ld @ Ld.mT - A64) \
        / torch.linalg.matrix_norm(A64)
    assert resid.max() < 5e-5, float(resid.max())
    L64 = torch.linalg.cholesky(A64)
    ld = 2 * torch.log(torch.diagonal(Ld, dim1=-2, dim2=-1)).sum(-1)
    ld64 = 2 * torch.log(torch.diagonal(L64, dim1=-2, dim2=-1)).sum(-1)
    # N = 1 at sigma^2 = 0.05 has log-determinant 0.05: absolute floor
    rtol = 1e-3 if case == "kuu" else 1e-5
    assert ((ld - ld64).abs() <= rtol * ld64.abs().clamp(min=1.0)).all()


@pytest.mark.parametrize("tf32x3", [False, True])
@pytest.mark.parametrize("nb", [8, 32])
def test_cholesky_blocked_plain_nan_set(nb, tf32x3):
    """NaN for exactly the matrices cholesky_plain gives up on, whole
    matrices; only the lower triangle is read; float64 agrees with
    cholesky_plain where it succeeds."""
    from waveome_tpu_torch.cuda_ops.chol_cuda import cholesky_blocked_plain
    A = torch.tensor(_spd_batch(45, B=5, noise=0.1), dtype=torch.float32)
    A[1] -= 3.0 * torch.eye(45)      # indefinite from the first panel on
    A[3, 40, 40] = -1.0              # a bad pivot in the last panel
    A[4, 20, 7] = A[4, 7, 20] = float("nan")
    L = cholesky_blocked_plain(
        torch.tril(A) + 9.0 * torch.triu(torch.ones_like(A), 1), nb, tf32x3)
    ref = cholesky_plain(A)
    bad = torch.isnan(ref).all(-1).all(-1)
    assert bad.tolist() == [False, True, False, True, True]
    assert torch.equal(torch.isnan(L).all(-1).all(-1), bad)
    assert torch.equal(torch.isnan(L).any(-1).any(-1), bad)
    assert_close(L[~bad], ref[~bad], rtol=1e-4, atol=1e-5)  # float32, other
    # summation order; cond ~ 1e2
    if not tf32x3:
        A64 = t64(_spd_batch(45, B=2, noise=0.1))
        assert_close(cholesky_blocked_plain(A64, nb), cholesky_plain(A64),
                     atol=1e-12)
