"""The CUDA kernels K1 (gram), K2 (Cholesky) and K3 (diagonal-block factor)
against their plain PyTorch versions, and the fit's default device, on the
GPU.

Every test here needs an NVIDIA GPU and the CUDA toolkit; without them each
skips. This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from waveome_tpu_torch.cuda_ops import chol_cuda, diag_factor_cuda, gram_cuda
from waveome_tpu_torch.datasets import simulate
from waveome_tpu_torch.fit import fit_outcomes_penalized
from waveome_tpu_torch.kernels import KernelSpec, Primitive, full_kernel_build
from waveome_tpu_torch.kernels.gram import gram, gram_plain
from waveome_tpu_torch.linalg import cholesky, cholesky_hybrid
from waveome_tpu_torch.tools import gram_nan_min

pytestmark = pytest.mark.cuda

# float32 on the card: K1 evaluates the same formulas as gram_plain, but
# with CUDA's libm (exp, sin, pow, acos within 2 ulp) and fused
# multiply-adds, so results agree to a few ulp of the largest entry.
GRAM_RTOL = 1e-5
# K2 and cuSOLVER sum the Schur updates in different orders; on these
# grams (condition number up to ~1e5) the factors agree to ~1e-4 of max|L|.
CHOL_RTOL = 1e-3
# K3 against cholesky_ex + solve_triangular on 48x48 blocks: both are
# float32 with different summation orders; L11·L11⁻¹ = I to ~48·eps·cond.
DIAG_RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def all_ops_spec():
    """Every op of kernels/ops.py, arccosine at each order, products,
    a frozen factor and an all-empty component."""
    return KernelSpec((
        (Primitive("matern32", 0), Primitive("rational_quadratic", 1)),
        (Primitive("polynomial", 1, degree=2.0),),
        (Primitive("matern52", 0), Primitive("constant", 0)),
        (Primitive("arccosine", 1, order=0),),
        (Primitive("arccosine", 0, order=2), Primitive("periodic", 1)),
        (Primitive("arccosine", 1),),
        (Primitive("categorical", 2, train_variance=False),
         Primitive("squared_exponential", 1), Primitive("linear", 0)),
        (Primitive("matern12", 1),),
        (Primitive("empty"),),
    ))


def _design(rng, n):
    return np.column_stack([rng.normal(size=n), rng.normal(size=n),
                            rng.integers(0, 3, n)])


def test_gram_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    spec = all_ops_spec()
    sp = spec.padded()
    C, F = sp.num_components, sp.max_factors
    P, N, M = 5, 37, 45  # ragged against the 32 x 128 tiles
    X1 = torch.tensor(_design(rng, N), dtype=torch.float32, device=dev)
    X2 = torch.tensor(np.stack([_design(rng, M) for _ in range(P)]),
                      dtype=torch.float32, device=dev)
    raw = torch.tensor(0.5 * rng.normal(size=(P, C, F, 4)),
                       dtype=torch.float32, device=dev)
    cm = torch.tensor(rng.uniform(0.2, 1, (P, C)), dtype=torch.float32,
                      device=dev)
    fm = torch.tensor(rng.uniform(size=(P, C, F)) > 0.3,
                      dtype=torch.float32, device=dev)
    for cmi in (None, cm):
        for fmi in (None, fm):
            before = gram_cuda.launch_count
            got = gram_cuda.gram_forward(spec, raw, X1, X2, cmi, fmi)
            assert gram_cuda.launch_count == before + 1
            want = gram_plain(spec, raw, X1, X2, cmi, fmi)
            torch.cuda.synchronize()
            err = (got - want).abs().max() / want.abs().max()
            assert err < GRAM_RTOL, (cmi is None, fmi is None, float(err))


def _saturated(rng, P, dev):
    spec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                             return_sum=True)
    base = spec.init_raw_params_np()
    raw = torch.tensor(base + 0.3 * rng.normal(size=(P,) + base.shape),
                       dtype=torch.float32, device=dev)
    return spec, raw


def _sat_design(rng, shape, dev):
    """Columns id, time, female for the saturated kernel; ``shape`` is
    (rows,) or (P, rows)."""
    X = np.stack([rng.integers(0, 6, shape), rng.normal(size=shape),
                  rng.integers(0, 2, shape)], axis=-1)
    return torch.tensor(X, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("M", [499, 500, 501, 503])
def test_gram_kernel_row_alignment(dev, M):
    """Output rows of M floats are 16-byte aligned only when M % 4 == 0;
    the other widths take the scalar stores, and no store may reach past
    the end of a row (the entries after the view must stay untouched)."""
    rng = np.random.default_rng(2)
    P, N = 3, 70
    spec, raw = _saturated(rng, P, dev)
    X1 = _sat_design(rng, (P, N), dev)  # a design per parameter set
    X2 = _sat_design(rng, (P, M), dev)
    got = gram_cuda.gram_forward(spec, raw, X1, X2)
    want = gram_plain(spec, raw, X1, X2)
    torch.cuda.synchronize()
    assert got.shape == (P, N, M)
    assert (got - want).abs().max() / want.abs().max() < GRAM_RTOL
    got = gram_cuda.gram_forward(spec, raw, X1[0], X2[0])  # shared designs
    want = gram_plain(spec, raw, X1[0], X2[0])
    assert (got - want).abs().max() / want.abs().max() < GRAM_RTOL


def test_gram_kernel_many_parameter_sets(dev):
    """P beyond a grid dimension's 65,535 at a tiny N x M."""
    rng = np.random.default_rng(3)
    P = 70_000
    spec, raw = _saturated(rng, P, dev)
    X = _sat_design(rng, (5,), dev)
    X2 = _sat_design(rng, (7,), dev)
    got = gram_cuda.gram_forward(spec, raw, X, X2)
    want = gram_plain(spec, raw, X, X2)
    torch.cuda.synchronize()
    assert (got - want).abs().max() / want.abs().max() < GRAM_RTOL


def test_gram_kernel_gradient_matches_autograd(dev):
    rng = np.random.default_rng(1)
    spec, _ = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                                var_names=["id", "t", "f"], return_sum=True)
    X = torch.tensor(np.column_stack([rng.integers(0, 6, 40),
                                      rng.normal(size=40),
                                      rng.integers(0, 2, 40)]),
                     dtype=torch.float32, device=dev)
    sp = spec.padded()
    raw0 = torch.tensor(0.5 * rng.normal(size=(3, sp.num_components,
                                                sp.max_factors, 4)),
                        dtype=torch.float32, device=dev)
    cot = torch.tensor(rng.normal(size=(3, 40, 40)), dtype=torch.float32,
                       device=dev)
    raw = raw0.clone().requires_grad_(True)
    (gram(spec, raw, X) * cot).sum().backward()
    ref = raw0.clone().requires_grad_(True)
    (gram_plain(spec, ref, X) * cot).sum().backward()
    err = (raw.grad - ref.grad).abs().max() / ref.grad.abs().max()
    assert err < GRAM_RTOL


def _grams(N, B, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.normal(size=N))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.3 ** 2)
    noise = np.where(np.arange(B) % 2 == 0, 0.05, 1.0)
    return torch.tensor(K[None] + noise[:, None, None] * np.eye(N),
                        dtype=torch.float32, device=dev)


@pytest.mark.parametrize("N", [1, 33, 100, 500])
def test_cholesky_kernel_matches_plain(dev, N):
    A = _grams(N, 6, dev)
    before = chol_cuda.launch_count
    L = chol_cuda.cholesky_cuda(A)
    assert chol_cuda.launch_count == before + 1
    ref = chol_cuda.cholesky_plain(A)
    torch.cuda.synchronize()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    err = (L - ref).abs().max() / ref.abs().max()
    assert err < CHOL_RTOL, float(err)


# every edge of the tiling: below, at and above a panel (32) and a tile
# (32 x 64), N % 4 != 0 (the scalar loads and stores), more than one tile
@pytest.mark.parametrize("B", [1, 3, 256])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 64, 65, 100, 501, 1000])
def test_cholesky_kernel_panel_edges(dev, N, B):
    if B == 256 and N > 501:
        B = 16  # 256 x 1000 x 1000 float64 products are 2 GB apiece
    A = _grams(N, B, dev)
    # the strictly upper triangle must not be read
    A = torch.tril(A) + 7.0 * torch.triu(torch.ones_like(A), 1)
    if B > 2:
        A[1] -= 2.0 * torch.eye(N, device=dev)  # not positive definite
    L = chol_cuda.cholesky_cuda(A)
    ref = chol_cuda.cholesky_plain(torch.tril(A) + torch.tril(A, -1).mT)
    torch.cuda.synchronize()
    bad = torch.isnan(ref).all(-1).all(-1)
    assert torch.equal(torch.isnan(L).all(-1).all(-1), bad)
    assert torch.equal(torch.isnan(L).any(-1).any(-1), bad)
    good = ~bad
    assert torch.equal(torch.triu(L[good], 1), torch.zeros_like(L[good]))
    Ad = (torch.tril(A) + torch.tril(A, -1).mT)[good].double()
    Ld = L[good].double()
    resid = torch.linalg.matrix_norm(Ld @ Ld.mT - Ad) \
        / torch.linalg.matrix_norm(Ad)
    assert resid.max() < 5e-5, float(resid.max())  # ~N eps, a stable factor
    err = (L[good] - ref[good]).abs().max() / ref[good].abs().max()
    assert err < CHOL_RTOL, float(err)


def test_cholesky_kernel_unaligned_view(dev):
    """A batch whose storage does not start on a 16-byte boundary takes
    the scalar path."""
    A = _grams(64, 3, dev)
    buf = torch.empty(A.numel() + 1, dtype=torch.float32, device=dev)
    view = buf[1:].view_as(A)
    view.copy_(A)
    L = chol_cuda.cholesky_cuda(view)
    torch.cuda.synchronize()
    assert torch.equal(L, chol_cuda.cholesky_cuda(A))


def test_cholesky_kernel_nan_on_non_pd(dev):
    A = _grams(70, 4, dev)
    A[1] -= 3.0 * torch.eye(70, device=dev)  # indefinite
    A[2, 5, 5] = float("nan")
    L = chol_cuda.cholesky_cuda(A)
    torch.cuda.synchronize()
    assert torch.isnan(L[1]).all() and torch.isnan(L[2]).all()
    assert torch.isfinite(L[0]).all() and torch.isfinite(L[3]).all()
    assert torch.isnan(chol_cuda.cholesky_plain(A)[1]).all()


def test_cholesky_kernel_gradient(dev):
    A = _grams(64, 3, dev).double().cpu()
    want_A = A.clone().requires_grad_(True)
    torch.logdet(want_A).sum().backward()
    got_A = A.float().to(dev).requires_grad_(True)
    L = cholesky(got_A)
    (2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1))).sum().backward()
    err = (got_A.grad.cpu().double() - want_A.grad).abs().max()
    assert err / want_A.grad.abs().max() < CHOL_RTOL


def test_kernels_reject_float64(dev):
    A = _grams(8, 2, dev).double()
    with pytest.raises(TypeError):
        chol_cuda.cholesky_cuda(A)
    spec = all_ops_spec()
    sp = spec.padded()
    raw = torch.zeros((sp.num_components, sp.max_factors, 4),
                      dtype=torch.float64, device=dev)
    X = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        gram_cuda.gram_forward(spec, raw, X, X)


def test_diag_factor_kernel_matches_plain(dev):
    A = _grams(500, 8, dev)
    D = A[:, 96:144, 96:144].contiguous()  # a diagonal block of each gram
    before = diag_factor_cuda.launch_count
    L, Linv = diag_factor_cuda.diag_factor_cuda(D)
    assert diag_factor_cuda.launch_count == before + 1
    L_ref, Linv_ref = diag_factor_cuda.diag_factor_plain(D)
    torch.cuda.synchronize()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(Linv, 1), torch.zeros_like(Linv))
    assert (L - L_ref).abs().max() / L_ref.abs().max() < DIAG_RTOL
    assert (Linv - Linv_ref).abs().max() / Linv_ref.abs().max() < DIAG_RTOL
    eye = torch.eye(48, device=dev)
    assert (L @ Linv - eye).abs().max() < DIAG_RTOL
    # only the lower triangle is read
    L2, _ = diag_factor_cuda.diag_factor_cuda(
        torch.tril(D) + 5.0 * torch.triu(torch.ones_like(D), 1))
    assert torch.equal(L2, L)


def _diag_blocks(B, dev, seed=0):
    """B diagonal blocks of RBF grams + σ²I (σ² alternating 0.05 and 1),
    each from its own points."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.normal(size=(B, 48)), axis=1)
    K = np.exp(-0.5 * (x[:, :, None] - x[:, None, :]) ** 2 / 0.3 ** 2)
    noise = np.where(np.arange(B) % 2 == 0, 0.05, 1.0)
    return torch.tensor(K + noise[:, None, None] * np.eye(48),
                        dtype=torch.float32, device=dev)


def _assert_diag_close(L, Linv, D):
    L_ref, Linv_ref = diag_factor_cuda.diag_factor_plain(D)
    torch.cuda.synchronize()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(Linv, 1), torch.zeros_like(Linv))
    assert (L - L_ref).abs().max() / L_ref.abs().max() < DIAG_RTOL
    assert (Linv - Linv_ref).abs().max() / Linv_ref.abs().max() < DIAG_RTOL
    eye = torch.eye(48, device=D.device)
    assert (L @ Linv - eye).abs().max() < DIAG_RTOL


@pytest.mark.parametrize("B", [1, 2, 255, 256, 1024, 3000])
def test_diag_factor_kernel_batch_sizes(dev, B):
    """Partial blocks of warps (B % 4 != 0) and more than one wave (3000)."""
    D = _diag_blocks(B, dev, seed=B)
    before = diag_factor_cuda.launch_count
    L, Linv = diag_factor_cuda.diag_factor_cuda(D)
    assert diag_factor_cuda.launch_count == before + 1
    _assert_diag_close(L, Linv, D)


def test_diag_factor_kernel_in_place_on_padded_blocks(dev):
    """The hybrid's use: the diagonal blocks of a padded (B, 528, 528)
    buffer at every offset, written into another such buffer; every entry
    outside the block keeps its guard value."""
    B, Np = 6, 528
    W = torch.randn(B, Np, Np, device=dev)
    blocks = _diag_blocks(B * Np // 48, dev).view(Np // 48, B, 48, 48)
    guard = -7.0
    out = torch.full((B, Np, Np), guard, device=dev)
    inv = torch.empty(B, 48, 48, device=dev)
    written = torch.zeros(Np, Np, dtype=torch.bool, device=dev)
    for i, o in enumerate(range(0, Np - 47, 48)):
        W[:, o:o + 48, o:o + 48] = blocks[i]
        before = diag_factor_cuda.launch_count
        L, Linv = diag_factor_cuda.diag_factor_cuda(
            W[:, o:o + 48, o:o + 48], out[:, o:o + 48, o:o + 48], inv)
        assert diag_factor_cuda.launch_count == before + 1
        assert L.data_ptr() == out[:, o:o + 48, o:o + 48].data_ptr()
        _assert_diag_close(L, Linv, blocks[i])
        written[o:o + 48, o:o + 48] = True
        assert bool((out[:, ~written] == guard).all()), o


def test_diag_factor_kernel_unaligned_and_strided_views(dev):
    """A batch that does not start on a 16-byte boundary takes the scalar
    path and gives the same bits; a view whose last dimension is not of
    stride 1 raises, and so does a non-float32 batch."""
    D = _diag_blocks(9, dev)
    L, Linv = diag_factor_cuda.diag_factor_cuda(D)
    buf = torch.empty(3 * D.numel() + 1, device=dev)
    Du = buf[1:D.numel() + 1].view_as(D)
    Du.copy_(D)
    Lu = buf[D.numel() + 1:2 * D.numel() + 1].view_as(D)
    Linvu = buf[2 * D.numel() + 1:].view_as(D)
    got = diag_factor_cuda.diag_factor_cuda(Du, Lu, Linvu)
    torch.cuda.synchronize()
    assert torch.equal(got[0], L) and torch.equal(got[1], Linv)
    before = diag_factor_cuda.launch_count
    with pytest.raises(ValueError):
        diag_factor_cuda.diag_factor_cuda(D.transpose(1, 2))
    with pytest.raises(ValueError):
        diag_factor_cuda.diag_factor_cuda(D, L.transpose(1, 2))
    with pytest.raises(TypeError):
        diag_factor_cuda.diag_factor_cuda(D.double())
    assert diag_factor_cuda.launch_count == before


def test_diag_factor_kernel_matches_its_recurrence(dev):
    """Against diag_factor_steps_plain on the card: the same recurrence,
    also on blocks whose last pivot is below zero (finite, clamped), and
    with garbage above the diagonal, which is never read."""
    D = _diag_blocks(8, dev).double()
    D[4:, 47, 47] -= 2.0 * torch.linalg.eigvalsh(D[4:])[:, -1]
    D = D.float()
    upper = torch.triu(torch.ones(48, 48, dtype=torch.bool, device=dev), 1)
    L, Linv = diag_factor_cuda.diag_factor_cuda(
        torch.where(upper, float("nan"), D))
    L_ref, Linv_ref = diag_factor_cuda.diag_factor_steps_plain(D)
    torch.cuda.synchronize()
    assert torch.isfinite(L).all() and torch.isfinite(Linv).all()
    assert (L[4:, 47, 47] < -1e13).all()
    for got, want in ((L, L_ref), (Linv, Linv_ref)):
        scale = want.abs().amax((1, 2), keepdim=True)
        assert ((got - want).abs() / scale).max() < DIAG_RTOL


def test_cholesky_hybrid_matches_k2(dev):
    A = _grams(200, 6, dev)[1::2].contiguous()  # the sigma^2 = 1 grams
    before = diag_factor_cuda.launch_count
    L = cholesky_hybrid(A)
    assert diag_factor_cuda.launch_count == before + 5  # 200 -> 240 = 5x48
    ref = chol_cuda.cholesky_cuda(A)
    torch.cuda.synchronize()
    assert (L - ref).abs().max() / ref.abs().max() < CHOL_RTOL


def test_fit_runs_on_cuda_by_default(dev):
    X, Ys = simulate(n_units=10, n_per=6, n_outcomes=3)
    spec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                             return_sum=True)
    before = gram_cuda.launch_count
    res = fit_outcomes_penalized(X, Ys, spec, num_inducing_points=20,
                                 max_iter=5)
    assert res.results.loss.device.type == "cuda"
    assert gram_cuda.launch_count > before
    assert bool(torch.isfinite(res.results.loss).all())


def test_gram_loop_harness_runs_on_cuda_by_default(dev):
    before = gram_cuda.launch_count
    its, bad, hist = gram_nan_min.run(D=1, steps=2)
    assert hist.device.type == "cuda" and gram_cuda.launch_count > before
    assert its.tolist() == [2] * 4 and not bool(bad.any())
