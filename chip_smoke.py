#!/usr/bin/env python3
"""Smoke run of waveome_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: needs CUDA; prints the card's name and power limit;
2. builds the CUDA kernels from waveome_tpu_torch/csrc (one nvcc per
   source, all at once);
3. K1 (fused gram) against its plain PyTorch version: every op with both
   masks at ragged shapes, then the fit's shape (P = 4·256 parameter sets,
   N = M = 500, the bench's saturated kernel), and GramFn's gradient;
4. K2 (batched Cholesky) against cholesky_ex at B = 1024, N = 500 on RBF
   grams + σ²I: reconstruction, logdet against float64, NaN on a matrix
   that is not positive definite, CholeskyFn's gradient;
5. K3 (48×48 diagonal-block factor and inverse) on the first diagonal
   block of those 1024 grams against diag_factor_plain, and L11·L11⁻¹ = I;
   then cholesky_hybrid (K3 + panel GEMMs) on the grams against K2 and a
   float64 factorization, gated at σ² = 1 and recorded at σ² = 0.05;
6. K4's harness (tools/pallas_nan_min.py, ported onto K1 as
   waveome_tpu_torch/tools/gram_nan_min.py): finite gradients at every
   step and the same iterates as the loop through gram_plain;
7. the M = N path: fit_outcomes_penalized on datasets.simulate() (N = 500,
   256 outcomes, M = N, num_factor_iter = 0, max_iter = 200) in float32
   on the GPU, with the kernels' launch counts; then, on the CPU through
   the plain versions, the objective, masks and importances at the GPU's
   fitted parameters of 8 outcomes (CPU_ROWS), and those 8 outcomes fitted
   again, compared;
8. the sparse path at the users' defaults: datasets.simulate(200, 10, 256)
   (N = 2000), fit_outcomes_penalized(X, Ys, spec, max_iter=200) with every
   other argument at its default (M = 500 inducing points trained with the
   collapsed bound, num_factor_iter = 5, float32, on the GPU); on the CPU,
   the objective, masks and importances of 8 outcomes at the GPU's
   parameters, and 4 outcomes fitted again from the same seed (same Z);
9. the hybrid opt-in: 64 of those outcomes with num_factor_iter = 0 and
   hybrid_trial_cholesky on and off; K3 must launch, the two fits are
   printed side by side and not gated (the reference records that the
   hybrid's explicit-inverse panels disagree on real grams).

Prints the kernels' JSON line, then the card, then the last line
{"ok": true, "device": {...}} only when every check passed; exits 1
otherwise. Imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# Tolerances (float32 on the card; the reasons are in PERF.md):
GRAM_RTOL = 1e-5  # K1 vs gram_plain, relative to max|K|: libm ulps
GRAM_GRAD_RTOL = 1e-4  # analytic vs autograd: f32 sums of N·M terms
CHOL_RESID_TOL = 5e-5  # ‖LLᵀ − A‖_F / ‖A‖_F, ~N·eps for a stable Cholesky
LOGDET_RTOL = 1e-5  # |logdet − logdet_f64| / |logdet_f64|
CHOL_GRAD_RTOL = 1e-3  # ∂logdet/∂A = A⁻¹ on the σ² = 1 grams, vs autograd
FINITE_MIN = 0.95  # finite fraction of the fit's losses (the bench's bar)
# Finite fraction of the importances: the reference's own float32 fit gives
# NaN scores where the kept kernel is low-rank and the Kuu Cholesky (jitter
# 1e-4) fails, e.g. bench outcomes 54 and 58 (ROADMAP Queue 3)
IMP_FINITE_MIN = 0.9
# The outcomes checked on the CPU: the first six, and 54 and 58, whose
# float32 importances are NaN in the reference's own fit
CPU_ROWS = [0, 1, 2, 3, 4, 5, 54, 58]
OBJ_RTOL = 1e-4  # the GPU's final losses re-evaluated by the CPU path
IMP_ATOL, IMP_RTOL = 0.1, 1e-3  # importances at the same parameters
# GPU vs CPU fits from scratch: float32 L-BFGS endpoints move with
# rounding (up to 1.2e-2 between CPU thread counts on 16 bench outcomes)
CPU_FIT_RTOL = 3e-2
# K3 vs cholesky_ex + solve_triangular on 48x48 blocks, relative to max|L|
# and max|L⁻¹|: float32 with other summation orders (cond(L11) <= ~150)
DIAG_RTOL = 1e-4
DIAG_INV_TOL = 1e-4  # max |L11·L11⁻¹ − I|
# cholesky_hybrid vs a float64 factorization on the σ² = 1 grams, relative
# to max|L|: the explicit-inverse panel solve with one refinement round
# keeps ~cond(L11)²·eps; logdet relative error. σ² = 0.05 is recorded only
HYBRID_RTOL = 1e-3
HYBRID_LOGDET_RTOL = 1e-4
# the harness loop through K1 vs through gram_plain: float32 analytic vs
# autograd backward, 8 steps (2.4e-6 apart on the CPU)
HARNESS_TOL = 1e-5
EXACT_OUTCOMES = 256  # the M = N path (N = 500)
# the sparse path: N = 2000 (200 units x 10 times), M = 500, CPU checks
SPARSE = dict(n_units=200, n_per=10, n_outcomes=256)
SPARSE_CPU_ROWS = list(range(8))  # re-evaluated at the GPU's parameters
SPARSE_REFIT_ROWS = list(range(4))  # refitted on the CPU (~1 min)
# At M = 500 the saturated kernel's rank on Z is below M (cat[id] repeats
# across Z's rows, SE[time] with a long lengthscale is smooth), so Kuu's
# condition number reaches max eigenvalue / jitter ~ 4e7: float32 solves
# through it differ between the CPU and the GPU by ~1e-4 of the loss
# (2.6e-4 measured on 16 outcomes), and the CPU's float32 Cholesky of Kuu
# can fail where K2's succeeded (the reference's own float32 limit, ROADMAP
# Queue 3). Such a row is reported, and compared no further.
SPARSE_OBJ_RTOL = 1e-3
# For the same reason more leave-one-out predictions lose their Kuu
# factorization than at M = N: 24 of 256 importance rows NaN (0.906)
SPARSE_IMP_FINITE_MIN = 0.85
HYBRID_OUTCOMES = 64
# H100 SXM peaks for bound_ms (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12

failures = []


def check(ok, what):
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time for ``nbytes`` moved and
    ``ops`` float32 operations at the card's peak rates."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_entry(name, source, replaces, err, ms, plain_ms, nbytes, ops,
                 library_ms=None):
    b_ms, b_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def reset_counts():
    from waveome_tpu_torch.cuda_ops import (
        chol_cuda,
        diag_factor_cuda,
        gram_cuda,
    )
    gram_cuda.launch_count = chol_cuda.launch_count = 0
    diag_factor_cuda.launch_count = 0


def read_counts():
    import torch

    from waveome_tpu_torch.cuda_ops import (
        chol_cuda,
        diag_factor_cuda,
        gram_cuda,
    )
    torch.cuda.synchronize()
    return {"K1": gram_cuda.launch_count, "K2": chol_cuda.launch_count,
            "K3": diag_factor_cuda.launch_count}


def cuda_ms(fn, reps=5):
    """Mean milliseconds of fn() on the card (CUDA events, after warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gram_checks(dev):
    import torch

    from waveome_tpu_torch.kernels import (
        KernelSpec,
        Primitive,
        full_kernel_build,
    )
    from waveome_tpu_torch.kernels.gram import gram, gram_plain

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    # every op, arccosine at each order, products, an empty component
    spec = KernelSpec((
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
    sp = spec.padded()
    C, F = sp.num_components, sp.max_factors
    P, N, M = 5, 37, 45
    X1 = torch.cat([rnd(N, 2), torch.randint(0, 3, (N, 1), generator=g)
                    .float().to(dev)], 1)
    X2 = torch.cat([rnd(P, M, 2), torch.randint(0, 3, (P, M, 1), generator=g)
                    .float().to(dev)], 2)
    raw = rnd(P, C, F, 4, scale=0.5)
    cm = torch.rand(P, C, generator=g).to(dev)
    fm = (torch.rand(P, C, F, generator=g) > 0.3).float().to(dev)
    worst = 0.0
    for cmi in (None, cm):
        for fmi in (None, fm):
            got = gram(spec, raw, X1, X2, cmi, fmi)
            want = gram_plain(spec, raw, X1, X2, cmi, fmi)
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max()))
    check(worst < GRAM_RTOL, f"K1 all 12 ops, both masks, ragged "
          f"{P}x{N}x{M}: max rel err {worst:.3g} < {GRAM_RTOL}")

    # the fit's shape: 4 trials x 256 outcomes, N = M = 500
    from waveome_tpu_torch.datasets import simulate
    X = torch.tensor(simulate(n_outcomes=1)[0], dtype=torch.float32,
                     device=dev)
    spec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                             return_sum=True)
    base = torch.tensor(spec.init_raw_params_np(), dtype=torch.float32)
    raw = base.to(dev) + rnd(1024, *base.shape, scale=0.3)
    got = gram(spec, raw, X)
    want = gram_plain(spec, raw, X)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    check(rel < GRAM_RTOL, f"K1 at 1024x500x500: max abs err {err:.3g}, "
          f"rel {rel:.3g} < {GRAM_RTOL}")
    del got, want
    ms = cuda_ms(lambda: gram(spec, raw, X))
    plain_ms = cuda_ms(lambda: gram_plain(spec, raw, X))
    print(f"K1 1024x500x500: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"({1024 * 500 * 500 * 4 / ms / 1e6:.1f} GB/s written)")

    # GramFn's analytic backward vs autograd through gram_plain, at the
    # gradient's shape (256 outcomes)
    r1 = raw[:256].clone().requires_grad_(True)
    r2 = raw[:256].clone().requires_grad_(True)
    cot = rnd(256, 500, 500)
    (gram(spec, r1, X) * cot).sum().backward()
    (gram_plain(spec, r2, X) * cot).sum().backward()
    grel = float((r1.grad - r2.grad).abs().max() / r2.grad.abs().max())
    check(grel < GRAM_GRAD_RTOL, f"GramFn backward vs autograd at "
          f"256x500x500: max rel err {grel:.3g} < {GRAM_GRAD_RTOL}")
    return kernel_entry(
        "K1 fused sum-of-products gram", "waveome_tpu_torch/csrc/gram.cu",
        "waveome_tpu/pallas_ops/gram_pallas.py:159", err, ms, plain_ms,
        *gram_work(spec, 1024, 500, 500, 3))


def gram_work(spec, P, N, M, D):
    """(bytes, operations) of one gram call: K written once, X1, X2 and
    the parameters read once; ~8 float operations per active factor and
    one add per component for each entry of K."""
    sp = spec.padded()
    C, F = sp.num_components, sp.max_factors
    factors = int(spec.active_factor_mask().sum())
    nbytes = 4 * (P * N * M + (N + M) * D + P * C * F * 4)
    return nbytes, P * N * M * (8 * factors + C)


def chol_checks(dev):
    import torch

    from waveome_tpu_torch.cuda_ops import chol_cuda
    from waveome_tpu_torch.linalg import cholesky

    B, N = 1024, 500
    rng = np.random.default_rng(0)
    x = np.sort(rng.normal(size=N))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.3 ** 2)
    noise = np.where(np.arange(B) % 2 == 0, 0.05, 1.0)
    scale = rng.uniform(0.5, 2.0, B)
    A64 = torch.tensor(scale[:, None, None] * K[None]
                       + noise[:, None, None] * np.eye(N), device=dev)
    A = A64.float()
    L = chol_cuda.cholesky_forward(A)
    ref = chol_cuda.cholesky_plain(A)
    err = float((L - ref).abs().max())
    Ld = L.double()
    resid = torch.linalg.matrix_norm(Ld @ Ld.transpose(-1, -2) - A64) \
        / torch.linalg.matrix_norm(A64)
    rd = ref.double()
    resid_ref = torch.linalg.matrix_norm(rd @ rd.transpose(-1, -2) - A64) \
        / torch.linalg.matrix_norm(A64)
    check(bool(torch.isfinite(L).all()) and float(resid.max())
          < CHOL_RESID_TOL,
          f"K2 at {B}x{N}x{N}: max |L - L_cholesky_ex| {err:.3g}; "
          f"max ||LL'-A||/||A|| {float(resid.max()):.3g} < {CHOL_RESID_TOL} "
          f"(cholesky_ex {float(resid_ref.max()):.3g})")

    def logdet(L):
        return 2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).double() \
            .sum(-1)
    ld64 = logdet(torch.linalg.cholesky(A64))
    ld_rel = float(((logdet(L) - ld64).abs() / ld64.abs()).max())
    ld_rel_ref = float(((logdet(ref) - ld64).abs() / ld64.abs()).max())
    check(ld_rel < LOGDET_RTOL, f"K2 logdet vs float64 (sigma^2 in "
          f"{{0.05, 1}}): max rel err {ld_rel:.3g} < {LOGDET_RTOL} "
          f"(cholesky_ex {ld_rel_ref:.3g})")

    bad = A[:4].clone()
    bad[1] -= 3.0 * torch.eye(N, device=dev)
    bad[2, 7, 7] = float("nan")
    Lb = chol_cuda.cholesky_forward(bad)
    torch.cuda.synchronize()
    check(bool(torch.isnan(Lb[1]).all() and torch.isnan(Lb[2]).all()
               and torch.isfinite(Lb[0]).all()),
          "K2 gives NaN for a matrix that is not positive definite, "
          "without raising")

    Aw = A[1:64:2]  # the sigma^2 = 1 grams
    a1 = Aw.clone().requires_grad_(True)
    a2 = Aw.clone().requires_grad_(True)
    logdet(cholesky(a1)).sum().backward()
    logdet(torch.linalg.cholesky(a2)).sum().backward()
    grel = float((a1.grad - a2.grad).abs().max() / a2.grad.abs().max())
    check(grel < CHOL_GRAD_RTOL, f"CholeskyFn gradient vs autograd of "
          f"torch.linalg.cholesky: max rel err {grel:.3g} < {CHOL_GRAD_RTOL}")

    ms = cuda_ms(lambda: chol_cuda.cholesky_forward(A))
    plain_ms = cuda_ms(lambda: chol_cuda.cholesky_plain(A))
    lib_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(A))
    print(f"K2 {B}x{N}x{N}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"cholesky_ex {lib_ms:.3f} ms "
          f"({B * N ** 3 / 3 * 2 / ms / 1e9:.2f} TFLOP/s)")
    # N³/3 FMAs per matrix; A read and L written once
    entry = kernel_entry(
        "K2 batched blocked Cholesky", "waveome_tpu_torch/csrc/chol.cu",
        "waveome_tpu/pallas_ops/chol_pallas.py:94", err, ms, plain_ms,
        2 * 4 * B * N * N, 2 * B * N ** 3 / 3, library_ms=lib_ms)
    return entry, A, A64, noise


def diag_checks(dev, A, A64, noise):
    """K3 on the first 48x48 diagonal block of each gram, then the hybrid
    Cholesky it serves, on the whole grams."""
    import torch

    from waveome_tpu_torch.cuda_ops import chol_cuda, diag_factor_cuda
    from waveome_tpu_torch.linalg import cholesky_hybrid

    B, N = A.shape[0], A.shape[-1]
    nb = diag_factor_cuda.NB
    D = A[:, :nb, :nb].contiguous()
    L, Linv = diag_factor_cuda.diag_factor_cuda(D)
    L_ref, Linv_ref = diag_factor_cuda.diag_factor_plain(D)
    err = float((L - L_ref).abs().max())
    rel = err / float(L_ref.abs().max())
    inv_rel = float((Linv - Linv_ref).abs().max() / Linv_ref.abs().max())
    eye_err = float((L @ Linv - torch.eye(nb, device=dev)).abs().max())
    upper = bool((torch.triu(L, 1) == 0).all() and (torch.triu(Linv, 1)
                                                      == 0).all())
    check(rel < DIAG_RTOL and inv_rel < DIAG_RTOL and eye_err < DIAG_INV_TOL
          and upper,
          f"K3 at {B}x{nb}x{nb}: max |L - L_plain| {err:.3g} (rel {rel:.3g}),"
          f" L^-1 rel {inv_rel:.3g} < {DIAG_RTOL}; max |L L^-1 - I| "
          f"{eye_err:.3g} < {DIAG_INV_TOL}; upper triangles zero {upper}")
    ms = cuda_ms(lambda: diag_factor_cuda.diag_factor_cuda(D), reps=50)
    plain_ms = cuda_ms(lambda: diag_factor_cuda.diag_factor_plain(D),
                       reps=20)
    print(f"K3 {B}x{nb}x{nb}: kernel {ms * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} us")
    # D's lower triangle read (the kernel reads no other entry), L and L⁻¹
    # written whole; ~n³/3 FMAs for the factor and ~n³/6 for the inverse,
    # n³ float operations per block
    entry = kernel_entry(
        "K3 48x48 diagonal-block factor and inverse",
        "waveome_tpu_torch/csrc/diag_factor.cu",
        "waveome_tpu/pallas_ops/chol_pallas.py:212", err, ms, plain_ms,
        4 * B * (nb * (nb + 1) // 2 + 2 * nb * nb), B * nb ** 3)

    Lh = cholesky_hybrid(A)
    L2 = chol_cuda.cholesky_forward(A)
    L64 = torch.linalg.cholesky(A64)

    def errs(Lx):
        Ld = Lx.double()
        rel = (Ld - L64).abs().amax((1, 2)) / L64.abs().amax((1, 2))
        ld = 2 * torch.log(torch.diagonal(Ld, dim1=-2, dim2=-1)).sum(-1)
        ld64 = 2 * torch.log(torch.diagonal(L64, dim1=-2, dim2=-1)).sum(-1)
        return rel, (ld - ld64).abs() / ld64.abs()

    h_rel, h_ld = errs(Lh)
    k_rel, k_ld = errs(L2)
    one = torch.as_tensor(noise == 1.0, device=dev)
    finite = bool(torch.isfinite(Lh[one]).all())
    check(finite and float(h_rel[one].max()) < HYBRID_RTOL
          and float(h_ld[one].max()) < HYBRID_LOGDET_RTOL,
          f"cholesky_hybrid at {B}x{N}x{N}, sigma^2 = 1: max |L - L_f64| / "
          f"max|L| {float(h_rel[one].max()):.3g} < {HYBRID_RTOL} (K2 "
          f"{float(k_rel[one].max()):.3g}), logdet rel err "
          f"{float(h_ld[one].max()):.3g} < {HYBRID_LOGDET_RTOL} (K2 "
          f"{float(k_ld[one].max()):.3g})")
    low = ~one
    print(f"cholesky_hybrid, sigma^2 = 0.05 (recorded, not gated): max "
          f"|L - L_f64| / max|L| {float(h_rel[low].nan_to_num(1e30).max()):.3g}"
          f" (K2 {float(k_rel[low].max()):.3g}), logdet rel err "
          f"{float(h_ld[low].nan_to_num(1e30).max()):.3g} (K2 "
          f"{float(k_ld[low].max()):.3g}), non-finite factors "
          f"{int((~torch.isfinite(Lh[low]).all(-1).all(-1)).sum())} of "
          f"{int(low.sum())}")
    del Lh, L2, L64
    h_ms = cuda_ms(lambda: cholesky_hybrid(A), reps=3)
    k2_ms = cuda_ms(lambda: chol_cuda.cholesky_forward(A), reps=3)
    print(f"cholesky_hybrid {B}x{N}x{N}: {h_ms:.3f} ms (K2 {k2_ms:.3f} ms)")
    return entry


def harness_checks(dev):
    """K4's harness on K1: finite gradients at every step, and the same
    iterates as the loop through gram_plain."""
    import torch

    from waveome_tpu_torch.cuda_ops import gram_cuda
    from waveome_tpu_torch.kernels import KernelSpec, Primitive
    from waveome_tpu_torch.kernels.gram import gram_plain
    from waveome_tpu_torch.tools import gram_nan_min

    reset_counts()
    runs = {D: gram_nan_min.run(D=D, device=dev) for D in (1, 2)}
    launches = read_counts()["K1"]
    worst, ok = 0.0, launches > 0
    for D, (its, bad, hist) in runs.items():
        its_p, bad_p, hist_p = gram_nan_min.run(D=D, plain=True, device=dev)
        worst = max(worst, float((hist - hist_p).abs().max()))
        ok &= bool((its == 8).all() and not bad.any() and not bad_p.any())
        print(f"harness D={D}: iters {its.tolist()}, NaN gradients "
              f"{bad.tolist()}; through gram_plain {its_p.tolist()}, "
              f"{bad_p.tolist()}")
    check(ok and worst < HARNESS_TOL,
          f"K4 harness on K1 ({launches} launches): all 8 steps with finite "
          f"gradients, iterates within {worst:.3g} < {HARNESS_TOL} of the "
          f"gram_plain loop")

    spec = KernelSpec(((Primitive("squared_exponential", 0),),))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 128, 1, generator=g).to(dev)
    raw = (0.5 * torch.randn(4, 1, 1, 4, generator=g)).to(dev)
    got = gram_cuda.gram_forward(spec, raw, x, x)
    err = float((got - gram_plain(spec, raw, x)).abs().max())
    ms = cuda_ms(lambda: gram_cuda.gram_forward(spec, raw, x, x), reps=50)
    plain_ms = cuda_ms(lambda: gram_plain(spec, raw, x), reps=50)
    print(f"K4 shape (K1) 4x128x128: kernel {ms * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} us")
    entry = kernel_entry(
        "K4 one-component SE gram in the loop harness (K1)",
        "waveome_tpu_torch/csrc/gram.cu", "tools/pallas_nan_min.py:65", err,
        ms, plain_ms, *gram_work(spec, 4, 128, 128, 1))
    entry["launches"] = launches
    return entry


def cpu_chol_fails(config, params, X):
    """Per row: does the CPU's float32 Cholesky of the objective's first
    matrix fail (Kuu + jitter I when M < N, K + σ²I when M = N)?"""
    import torch

    from waveome_tpu_torch.config import default_jitter
    from waveome_tpu_torch.kernels.gram import gram_plain

    raw, Z = params["kernel_raw"], params["z"]
    if config.num_inducing < X.shape[0]:
        K = gram_plain(config.spec, raw, Z, Z)
        K = K + default_jitter(K.dtype) * torch.eye(K.shape[-1])
    else:
        noise = config.likelihood.constrain(params["lik_raw"])[..., 0]
        K = gram_plain(config.spec, raw, X)
        K = K + noise[:, None, None] * torch.eye(K.shape[-1])
    return torch.linalg.cholesky_ex(K)[1] > 0


def fit_path(dev, label, X, Ys, kw, max_iter, cpu_rows, refit_rows,
             obj_rtol=OBJ_RTOL, imp_finite_min=IMP_FINITE_MIN):
    """fit_outcomes_penalized on the GPU (after a short warm-up), checked;
    then on the CPU through the plain versions: the objective, masks and
    importances of ``cpu_rows`` at the GPU's parameters, and
    ``refit_rows`` fitted from scratch. Returns (result, launches)."""
    import torch

    from waveome_tpu_torch.fit import fit_outcomes_penalized
    from waveome_tpu_torch.fit import penalized_finalize
    from waveome_tpu_torch.fit.batch import penalized_objective

    n_outcomes = Ys.shape[1]
    # warm-up: cuBLAS/cuSOLVER handles and the caching allocator
    fit_outcomes_penalized(X, Ys[:, :8], max_iter=2,
                           **dict(kw, num_factor_iter=0), device=dev)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    res = fit_outcomes_penalized(X, Ys, max_iter=max_iter, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    r = res.results
    loss = r.loss.cpu()
    finite = float(torch.isfinite(loss).float().mean())
    iters = r.num_iters.cpu().double()
    rounds = r.factor_rounds.cpu().double()
    C = res.config.num_components
    print(f"{label}: fit_outcomes_penalized N={X.shape[0]} "
          f"M={res.config.num_inducing} outcomes={n_outcomes} "
          f"max_iter={max_iter} float32 on {torch.cuda.get_device_name(0)}: "
          f"wall {wall:.2f} s, {n_outcomes / (wall / 60):.1f} fits/min, "
          f"mean iters {float(iters.mean()):.1f} (max {int(iters.max())}), "
          f"factor rounds mean {float(rounds.mean()):.2f} (max "
          f"{int(rounds.max())}), finite fraction {finite:.3f}, launches "
          f"{launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    check(finite >= FINITE_MIN, f"{label}: finite fraction {finite:.3f} >= "
          f"{FINITE_MIN}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"{label}: the fit launched K1 {launches['K1']} and K2 "
          f"{launches['K2']} times")
    shapes = (tuple(r.importances.shape), tuple(r.component_mask.shape),
              tuple(r.factor_mask.shape))
    check(shapes == ((n_outcomes, C + 1), (n_outcomes, C),
                     (n_outcomes, C, 2)), f"{label}: result shapes {shapes}")
    imp_ok = torch.isfinite(r.importances).all(1).cpu()
    imp_finite = float(imp_ok.float().mean())
    check(imp_finite >= imp_finite_min, f"{label}: finite fraction of "
          f"importances {imp_finite:.3f} >= {imp_finite_min} (NaN for "
          f"outcomes {torch.nonzero(~imp_ok).flatten().tolist()})")

    # the CPU path (plain versions): the objective, masks and importances
    # at the GPU's fitted parameters, then a fit from scratch
    sel = torch.tensor(cpu_rows)
    rows = {k: v.cpu()[sel] for k, v in r.params.items()}
    Xc = torch.tensor(X, dtype=torch.float32)
    Yc = torch.tensor(Ys.T[cpu_rows, :, None], dtype=torch.float32)
    with torch.no_grad():
        obj = penalized_objective(res.config, rows, Xc, Yc,
                                  r.penalization_factor.cpu()[sel])
        cm_c, fm_c, imp_c = penalized_finalize(res.config, rows, Xc, Yc)
    gl = loss[sel].double()
    orel = (obj.double() - gl).abs() / gl.abs().clamp(min=1.0)
    # a row the CPU cannot evaluate must be one whose float32 Cholesky fails
    lost = ~torch.isfinite(obj)
    excused = lost & cpu_chol_fails(res.config, rows, Xc)
    worst = float(orel[~lost].max()) if bool((~lost).any()) else 0.0
    check(worst < obj_rtol and bool((lost == excused).all())
          and bool(torch.isfinite(gl).all()),
          f"{label}: CPU objective at the GPU's parameters (outcomes "
          f"{cpu_rows}): max rel diff {worst:.3g} < {obj_rtol}; not "
          f"finite on the CPU for outcomes "
          f"{[cpu_rows[i] for i in torch.nonzero(lost).flatten().tolist()]}"
          f", each where the CPU's float32 Cholesky of the objective's "
          f"matrix fails: {bool((lost == excused).all())}")
    imp_g = r.importances.cpu()[sel]
    both = torch.isfinite(imp_g) & torch.isfinite(imp_c)
    # scores are rounded to 0.1, so rounding may split them by one step
    excess = (imp_g - imp_c).abs() - IMP_ATOL - IMP_RTOL * imp_c.abs()
    imp_err = float(excess[both].max()) if bool(both.any()) else 0.0
    same = bool((cm_c == r.component_mask.cpu()[sel]).all()
                and (fm_c == r.factor_mask.cpu()[sel]).all())
    check(same and imp_err <= 0, f"{label}: CPU masks and importances at the "
          f"GPU's parameters: same masks {same}; finite scores agree within "
          f"{IMP_ATOL} + {IMP_RTOL}*|score| ({int(both.all(1).sum())} of "
          f"{len(cpu_rows)} outcomes finite on both)")
    t0 = time.perf_counter()
    cpu = fit_outcomes_penalized(X, Ys[:, refit_rows], max_iter=max_iter,
                                 device="cpu", **kw).results
    cpu_s = time.perf_counter() - t0
    ref = torch.tensor(refit_rows)
    gl, cl = loss[ref].double(), cpu.loss.double()
    lrel = float(((gl - cl).abs() / cl.abs().clamp(min=1.0)).max())
    same_cm = bool((r.component_mask.cpu()[ref] == cpu.component_mask).all())
    same_fm = bool((r.factor_mask.cpu()[ref] == cpu.factor_mask).all())
    print(f"{label}: CPU plain path, outcomes {refit_rows}: {cpu_s:.1f} s; "
          f"GPU losses {[round(v, 4) for v in gl.tolist()]}, CPU "
          f"{[round(v, 4) for v in cl.tolist()]}; GPU factors "
          f"{[round(v, 4) for v in r.penalization_factor[ref].tolist()]}, "
          f"CPU {[round(v, 4) for v in cpu.penalization_factor.tolist()]}")
    check(lrel < CPU_FIT_RTOL and same_cm and same_fm,
          f"{label}: GPU vs CPU fits: max rel loss diff {lrel:.3g} < "
          f"{CPU_FIT_RTOL}, same component masks {same_cm}, same factor "
          f"masks {same_fm}")
    return res, launches


def hybrid_optin(dev, X, Ys, spec):
    """The trial Cholesky opt-in against the default on the same outcomes;
    K3 must launch, agreement is printed and not gated."""
    import torch

    from waveome_tpu_torch.fit import fit_outcomes_penalized

    kw = dict(spec=spec, num_factor_iter=0, max_iter=200, device=dev)
    Yh = Ys[:, :HYBRID_OUTCOMES]
    out = {}
    for on in (False, True):
        reset_counts()
        t0 = time.perf_counter()
        r = fit_outcomes_penalized(X, Yh, hybrid_trial_cholesky=on,
                                   **kw).results
        torch.cuda.synchronize()
        out[on] = (r, time.perf_counter() - t0, read_counts())
    (off, w_off, c_off), (onr, w_on, c_on) = out[False], out[True]
    lo, ln = off.loss.cpu().double(), onr.loss.cpu().double()
    rel = (ln - lo) / lo.abs().clamp(min=1.0)
    print(f"hybrid opt-in, {HYBRID_OUTCOMES} outcomes, num_factor_iter=0: "
          f"off {w_off:.2f} s, launches {c_off}, mean iters "
          f"{float(off.num_iters.double().mean()):.1f}; on {w_on:.2f} s, "
          f"launches {c_on}, mean iters "
          f"{float(onr.num_iters.double().mean()):.1f}; loss on - off: mean "
          f"{float((ln - lo).mean()):.4g}, rel max {float(rel.abs().max()):.3g}"
          f", finite on {float(torch.isfinite(ln).double().mean()):.3f}; "
          f"same masks {int((onr.component_mask == off.component_mask).all(1).sum())}"
          f" of {HYBRID_OUTCOMES}")
    print(f"  losses off {[round(v, 3) for v in lo.tolist()]}")
    print(f"  losses on  {[round(v, 3) for v in ln.tolist()]}")
    print(f"  iters off {off.num_iters.tolist()}")
    print(f"  iters on  {onr.num_iters.tolist()}")
    check(c_on["K3"] > 0, f"hybrid opt-in: the fit launched K3 "
          f"{c_on['K3']} times (off: {c_off['K3']})")
    return c_on


def run_phases(dev):
    """Phases 3-9; returns the kernels' entries."""
    import torch

    from waveome_tpu_torch.datasets import simulate
    from waveome_tpu_torch.kernels import full_kernel_build

    k1 = gram_checks(dev)
    k2, A, A64, noise = chol_checks(dev)
    k3 = diag_checks(dev, A, A64, noise)
    del A, A64
    k4 = harness_checks(dev)

    spec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                             return_sum=True)
    X, Ys = simulate(n_outcomes=EXACT_OUTCOMES)
    _, exact = fit_path(
        dev, "M = N path", X, Ys,
        dict(spec=spec, num_inducing_points=X.shape[0], num_factor_iter=0,
             dtype=torch.float32), 200, CPU_ROWS, CPU_ROWS)
    X, Ys = simulate(**SPARSE)
    # every argument but max_iter at its default: M = 500, 5 factor rounds
    _, sparse = fit_path(dev, "sparse path", X, Ys, dict(spec=spec), 200,
                         SPARSE_CPU_ROWS, SPARSE_REFIT_ROWS,
                         obj_rtol=SPARSE_OBJ_RTOL,
                         imp_finite_min=SPARSE_IMP_FINITE_MIN)
    optin = hybrid_optin(dev, X, Ys, spec)

    k1["launches"], k2["launches"] = sparse["K1"], sparse["K2"]
    k3["launches"] = optin["K3"]
    for k, name in ((k1, "K1"), (k2, "K2")):
        k["launches_by_path"] = {"M = N": exact[name], "sparse": sparse[name],
                                 "hybrid opt-in": optin[name]}
    return [k1, k2, k3, k4]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from waveome_tpu_torch.cuda_ops import _lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    _lib.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_lib.build_seconds if _lib.build_seconds is not None else 0:.2f}"
          f" s)")
    for line in (_lib.build_log or "").splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    kernels = run_phases(dev)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"device check")
    print(json.dumps({"kernels": kernels}))
    print(card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
