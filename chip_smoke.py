#!/usr/bin/env python3
"""Smoke run of waveome_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: needs CUDA; prints the card's name and power limit;
2. builds the CUDA kernels from waveome_tpu_torch/csrc (one nvcc per
   source, all at once);
3. K1 (fused gram) against its plain PyTorch version: every op with both
   masks at ragged shapes, output rows that are and are not 16-byte
   aligned (M = 499..503), then the fit's shape (P = 4·256 parameter sets,
   N = M = 500, the bench's saturated kernel), the sparse path's widest
   launch (P = 1024, a design per set of N = 500 rows, M = 2000), and
   GramFn's gradient;
4. K2 (batched Cholesky) against cholesky_ex at B = 1024 and B = 256,
   N = 500 on RBF grams + σ²I: reconstruction, logdet against float64, NaN
   on a matrix that is not positive definite, CholeskyFn's gradient; every
   panel and tile edge (N = 1..1000) on a small batch; and the Kuu gate:
   256 matrices Kuu + 1e-4·I of the sparse path's own design at perturbed
   parameters (condition number ~4e7), where K2 may fail no more often
   than cholesky_ex and its log-determinants may be at most twice as far
   from float64 as cholesky_ex's;
5. K3 (48×48 diagonal-block factor and inverse) against diag_factor_plain,
   and L11·L11⁻¹ = I: on the first diagonal block of those 1024 grams, and
   on the second block of 256 of them as the opt-in gives it (views of
   padded buffers, L11 written in place), with cholesky_ex alone timed
   beside it; then cholesky_hybrid (K3 + panel GEMMs) on the grams against
   K2 and a float64 factorization, gated at σ² = 1 and recorded at
   σ² = 0.05;
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
EDGE_ROWS = [54, 58]
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
SPARSE_EDGE_ROWS = [2]  # the CPU's float32 Cholesky of its Kuu fails
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
# K2's panel and tile edges, on a small batch
CHOL_EDGE_NS = [1, 31, 32, 33, 64, 65, 100, 501, 1000]
KUU_MATRICES = 256  # the Kuu gate's batch
KUU_LOGDET_SLACK = 2.0  # K2's worst logdet error over cholesky_ex's
GRAM_EDGE_MS = [499, 500, 501, 503]  # K1's output widths around M % 4 == 0
# The kernels' times before their redesign, ms (H100 80GB HBM3, 700 W; K1,
# K2, K3 and the hybrid at 1024 from PERF.md's table for the previous
# kernels, the other two from tools/bench_kernels.py on the previous csrc/,
# lowest of two turns):
# printed beside this run's times, and kept out of the kernels' JSON line,
# which holds only what this run measured
PREVIOUS_MS = {"K1": 6.580, "K2": 10.831, "K2 B=256": 3.339,
               "K1 M=2000": 23.173, "K3": 0.0756, "hybrid": 11.88}
# The two fits before the kernels' redesign (PERF.md: fits/min, mean
# iterations, K1 and K2 launches)
PREVIOUS_FIT = {"M = N path": "3921.7-4144.3 fits/min, 41.9 iterations, "
                              "165 K1 and 161 K2 launches",
                "sparse path": "581.2-587.6 fits/min, 43.5 iterations, "
                               "740 K1 and 708 K2 launches"}

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
    """Mean milliseconds of fn() on the card (CUDA events, after warm-up).
    The timed launches queue behind a spin of the device
    (``torch.cuda._sleep``) that outlasts the host's time to issue them, so
    that a kernel shorter than its Python launch path is timed back to back
    on the device and not at the host's pace."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0  # host and device, an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * per_call * reps, 0.2) * 2e9))  # ~2 GHz
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

    # output rows of M floats are 16-byte aligned only when M % 4 == 0;
    # the other widths take the scalar stores. Every entry is compared, so
    # a store past a row's end would show in the next row
    worst = 0.0
    Xw = torch.tensor(simulate(200, 10, 1)[0], dtype=torch.float32,
                      device=dev)
    for M in GRAM_EDGE_MS:
        x1 = X[None, :70] + rnd(3, 70, 3, scale=0.01)
        x2 = Xw[None, :M] + rnd(3, M, 3, scale=0.01)
        for a, b in ((x1, x2), (x1[0], x2[0])):
            got = gram(spec, raw[:3], a, b)
            want = gram_plain(spec, raw[:3], a, b)
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max()))
    check(worst < GRAM_RTOL, f"K1 at M in {GRAM_EDGE_MS} (3x70xM, designs "
          f"shared and per set): max rel err {worst:.3g} < {GRAM_RTOL}")
    got = gram(spec, raw, X)
    want = gram_plain(spec, raw, X)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    check(rel < GRAM_RTOL, f"K1 at 1024x500x500: max abs err {err:.3g}, "
          f"rel {rel:.3g} < {GRAM_RTOL}")
    del got, want
    ms = cuda_ms(lambda: gram(spec, raw, X))
    plain_ms = cuda_ms(lambda: gram_plain(spec, raw, X))
    print(f"K1 1024x500x500: kernel {ms:.3f} ms (before "
          f"{PREVIOUS_MS['K1']:.3f} ms), plain {plain_ms:.3f} ms "
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
    k1 = kernel_entry(
        "K1 fused sum-of-products gram", "waveome_tpu_torch/csrc/gram.cu",
        "waveome_tpu/pallas_ops/gram_pallas.py:159", err, ms, plain_ms,
        *gram_work(spec, 1024, 500, 500, 3))
    del r1, r2, cot

    # the sparse path's widest launch: Kuf for 4 trials x 256 outcomes,
    # each with its own M = 500 inducing rows, against N = 2000 samples
    # (the plain version goes in four chunks of 256 sets: its intermediates
    # of the whole batch would not fit beside the 4 GB of each result)
    Z = X[None] + rnd(1024, 500, 3, scale=0.01)
    chunks = [slice(i, i + 256) for i in range(0, 1024, 256)]
    got = gram(spec, raw, Z, Xw)
    err_w = top = 0.0
    for c in chunks:
        want = gram_plain(spec, raw[c], Z[c], Xw)
        err_w = max(err_w, float((got[c] - want).abs().max()))
        top = max(top, float(want.abs().max()))
    rel = err_w / top
    check(rel < GRAM_RTOL, f"K1 at 1024x500x2000, a design per set: max abs "
          f"err {err_w:.3g}, rel {rel:.3g} < {GRAM_RTOL}")
    del got, want
    ms_w = cuda_ms(lambda: gram(spec, raw, Z, Xw))

    def plain_chunks():
        for c in chunks:
            gram_plain(spec, raw[c], Z[c], Xw)
    plain_w = cuda_ms(plain_chunks, reps=2)
    k1w = kernel_entry(
        "K1 at the sparse path's widest launch (1024x500x2000, a design "
        "per set)", "waveome_tpu_torch/csrc/gram.cu",
        "waveome_tpu/pallas_ops/gram_pallas.py:159", err_w, ms_w, plain_w,
        *gram_work(spec, 1024, 500, 2000, 3, x1_sets=1024))
    print(f"K1 1024x500x2000: kernel {ms_w:.3f} ms (bound "
          f"{k1w['bound_ms']:.3f} ms, before "
          f"{PREVIOUS_MS['K1 M=2000']:.3f} ms), plain {plain_w:.3f} ms (in "
          f"four chunks of 256 sets), "
          f"{1024 * 500 * 2000 * 4 / ms_w / 1e6:.1f} GB/s written")
    return k1, k1w


def gram_work(spec, P, N, M, D, x1_sets=1):
    """(bytes, operations) of one gram call: K written once, X1 (one per
    set when ``x1_sets`` is P), X2 and the parameters read once; ~8 float
    operations per active factor and one add per component for each entry
    of K."""
    sp = spec.padded()
    C, F = sp.num_components, sp.max_factors
    factors = int(spec.active_factor_mask().sum())
    nbytes = 4 * (P * N * M + (x1_sets * N + M) * D + P * C * F * 4)
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
    resid, resid_ref = rel_residual(L, A64), rel_residual(ref, A64)
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

    chol_edge_checks(dev)
    kuu_gate(dev)

    entries = []
    for Bt, name, prev in (
            (B, "K2 batched blocked Cholesky", "K2"),
            (256, "K2 at the gradient's batch (256x500x500)", "K2 B=256")):
        At = A[:Bt]
        ms = cuda_ms(lambda: chol_cuda.cholesky_forward(At))
        plain_ms = cuda_ms(lambda: chol_cuda.cholesky_plain(At))
        lib_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(At))
        print(f"K2 {Bt}x{N}x{N}: kernel {ms:.3f} ms (before "
              f"{PREVIOUS_MS[prev]:.3f} ms), plain {plain_ms:.3f} ms, "
              f"cholesky_ex {lib_ms:.3f} ms "
              f"({Bt * N ** 3 / 3 * 2 / ms / 1e9:.2f} TFLOP/s)")
        # N³/3 FMAs per matrix; A read and L written once
        entries.append(kernel_entry(
            name, "waveome_tpu_torch/csrc/chol.cu",
            "waveome_tpu/pallas_ops/chol_pallas.py:94", err, ms, plain_ms,
            2 * 4 * Bt * N * N, 2 * Bt * N ** 3 / 3, library_ms=lib_ms))
    check(entries[0]["ms"] < entries[0]["library_ms"],
          f"K2 at {B}x{N}x{N} is faster than cholesky_ex: "
          f"{entries[0]['ms']:.3f} ms < {entries[0]['library_ms']:.3f} ms")
    return entries[0], entries[1], A, A64, noise


def rel_residual(L, A64):
    """‖LLᵀ − A‖_F / ‖A‖_F per matrix, in float64."""
    import torch
    Ld = L.double()
    return (torch.linalg.matrix_norm(Ld @ Ld.transpose(-1, -2) - A64)
            / torch.linalg.matrix_norm(A64))


def chol_edge_checks(dev):
    """K2 at every edge of its tiling (panels of 32, tiles of 32 x 64,
    N % 4 != 0) on a small batch with one matrix that is not positive
    definite: the same NaN set as cholesky_plain, zeros above the
    diagonal, the residual of the others."""
    import torch

    from waveome_tpu_torch.cuda_ops import chol_cuda

    worst, ok = 0.0, True
    for N in CHOL_EDGE_NS:
        rng = np.random.default_rng(N)
        x = np.sort(rng.normal(size=N))
        K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.3 ** 2)
        A64 = torch.tensor(K[None] + np.array([0.05, 1.0, 0.05, 1.0, 0.3])
                           [:, None, None] * np.eye(N), device=dev)
        A64[2] -= 2.0 * torch.eye(N, device=dev, dtype=torch.float64)
        A = A64.float()
        # only the lower triangle may be read
        L = chol_cuda.cholesky_forward(
            torch.tril(A) + 7.0 * torch.triu(torch.ones_like(A), 1))
        ref = chol_cuda.cholesky_plain(A)
        torch.cuda.synchronize()
        bad = torch.isnan(ref).all(-1).all(-1)
        good = ~bad
        ok &= bool((torch.isnan(L).all(-1).all(-1) == bad).all()
                   and (torch.isnan(L).any(-1).any(-1) == bad).all()
                   and bool(bad[2]) and int(bad.sum()) == 1
                   and (torch.triu(L[good], 1) == 0).all())
        worst = max(worst, float(rel_residual(L[good], A64[good]).max()))
    check(ok and worst < CHOL_RESID_TOL,
          f"K2 at N in {CHOL_EDGE_NS} (5 matrices, one not positive "
          f"definite): NaN for that one only, zeros above the diagonal, "
          f"upper triangle of A not read: {ok}; max ||LL'-A||/||A|| "
          f"{worst:.3g} < {CHOL_RESID_TOL}")


def kuu_gate(dev):
    """K2 where float32 is at its edge: Kuu + jitter·I of the sparse path's
    own design (the M = 500 inducing rows that the fit starts from) at
    randomly perturbed parameters. K2 may give NaN for no more matrices
    than cholesky_ex fails on, and where both and a float64 factorization
    succeed its log-determinants may be at most KUU_LOGDET_SLACK times as
    far from float64's as cholesky_ex's worst."""
    import torch

    from waveome_tpu_torch.config import default_jitter
    from waveome_tpu_torch.cuda_ops import chol_cuda
    from waveome_tpu_torch.datasets import simulate
    from waveome_tpu_torch.kernels import full_kernel_build
    from waveome_tpu_torch.kernels.gram import gram
    from waveome_tpu_torch.models import svgp

    spec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                             return_sum=True)
    X = simulate(**SPARSE)[0]
    config = svgp.make_config(spec, "gaussian", num_data=X.shape[0],
                              input_dim=X.shape[1], num_inducing_points=500)
    p0 = svgp.init_params(config, np.asarray(X, dtype=np.float64),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    raw0 = p0["kernel_raw"]
    raw = raw0 + torch.tensor(
        0.5 * rng.normal(size=(KUU_MATRICES,) + tuple(raw0.shape)),
        dtype=torch.float32, device=dev)
    M = p0["z"].shape[-2]
    Kuu = gram(spec, raw, p0["z"]) + default_jitter(torch.float32) \
        * torch.eye(M, device=dev)
    L = chol_cuda.cholesky_forward(Kuu)
    L_ex, info = torch.linalg.cholesky_ex(Kuu)
    L64, info64 = torch.linalg.cholesky_ex(Kuu.double())
    torch.cuda.synchronize()
    nan_k2 = torch.isnan(L).any(-1).any(-1)
    fail_ex = info != 0
    both = ~nan_k2 & ~fail_ex & (info64 == 0)

    def logdet(F):
        return 2 * torch.log(torch.diagonal(F, dim1=-2, dim2=-1).double()) \
            .sum(-1)
    ld64 = logdet(L64[both])
    e_k2 = float(((logdet(L[both]) - ld64).abs() / ld64.abs()).max())
    e_ex = float(((logdet(L_ex[both]) - ld64).abs() / ld64.abs()).max())
    evals = torch.linalg.eigvalsh(Kuu[:8].double())
    print(f"Kuu gate: {KUU_MATRICES} matrices {M}x{M}, condition numbers "
          f"{float((evals[:, -1] / evals[:, 0]).min()):.3g} to "
          f"{float((evals[:, -1] / evals[:, 0]).max()):.3g} (first 8); "
          f"residual K2 {float(rel_residual(L[both], Kuu[both].double()).max()):.3g}"
          f", cholesky_ex "
          f"{float(rel_residual(L_ex[both], Kuu[both].double()).max()):.3g}")
    check(int(nan_k2.sum()) <= int(fail_ex.sum()) and int(both.sum()) > 0
          and e_k2 <= KUU_LOGDET_SLACK * e_ex,
          f"Kuu gate: K2 NaN for {int(nan_k2.sum())} matrices <= "
          f"cholesky_ex's {int(fail_ex.sum())} failures (float64 fails on "
          f"{int((info64 != 0).sum())}); logdet vs float64 on the "
          f"{int(both.sum())} that all factor: K2 {e_k2:.3g} <= "
          f"{KUU_LOGDET_SLACK} x cholesky_ex {e_ex:.3g}")


def diag_checks(dev, A, A64, noise):
    """K3 on the first 48x48 diagonal block of each of the 1024 grams (the
    contiguous entry), and on the second diagonal block of 256 of them,
    read from a padded copy and written into a factor's block in place, as
    the hybrid opt-in's trials give it (the strided entry); then the hybrid
    Cholesky it serves, on the whole grams."""
    import torch

    from waveome_tpu_torch.cuda_ops import chol_cuda, diag_factor_cuda
    from waveome_tpu_torch.linalg import cholesky_hybrid

    B, N = A.shape[0], A.shape[-1]
    nb = diag_factor_cuda.NB
    Np = N + (-N) % nb
    entries, ex_ms = [], []
    for Bt in (B, 256):
        if Bt == B:
            D = A[:, :nb, :nb].contiguous()
            out = None, None
            how = "contiguous"
        else:
            W = torch.zeros(Bt, Np, Np, device=dev)
            W[:, :N, :N] = A[:Bt]
            D = W[:, nb:2 * nb, nb:2 * nb]
            Lbuf = torch.zeros(Bt, Np, Np, device=dev)
            out = Lbuf[:, nb:2 * nb, nb:2 * nb], torch.empty(
                Bt, nb, nb, device=dev)
            how = f"blocks of ({Bt}, {Np}, {Np}) buffers, in place"
        L, Linv = diag_factor_cuda.diag_factor_cuda(D, *out)
        L_ref, Linv_ref = diag_factor_cuda.diag_factor_plain(D)
        err = float((L - L_ref).abs().max())
        rel = err / float(L_ref.abs().max())
        inv_rel = float((Linv - Linv_ref).abs().max()
                        / Linv_ref.abs().max())
        eye_err = float((L @ Linv - torch.eye(nb, device=dev)).abs().max())
        upper = bool((torch.triu(L, 1) == 0).all()
                     and (torch.triu(Linv, 1) == 0).all())
        check(rel < DIAG_RTOL and inv_rel < DIAG_RTOL
              and eye_err < DIAG_INV_TOL and upper,
              f"K3 at {Bt}x{nb}x{nb} ({how}): max |L - L_plain| {err:.3g} "
              f"(rel {rel:.3g}), L^-1 rel {inv_rel:.3g} < {DIAG_RTOL}; max "
              f"|L L^-1 - I| {eye_err:.3g} < {DIAG_INV_TOL}; upper triangles "
              f"zero {upper}")
        ms = cuda_ms(lambda: diag_factor_cuda.diag_factor_cuda(D, *out),
                     reps=200)
        plain_ms = cuda_ms(lambda: diag_factor_cuda.diag_factor_plain(D),
                           reps=20)
        ex_ms.append(cuda_ms(lambda: torch.linalg.cholesky_ex(D), reps=50))
        print(f"K3 {Bt}x{nb}x{nb} ({how}): kernel {ms * 1e3:.2f} us "
              f"(before the redesign: {PREVIOUS_MS['K3'] * 1e3:.1f} us at "
              f"1024), plain {plain_ms * 1e3:.1f} us; cholesky_ex alone (L "
              f"without L^-1) {ex_ms[-1] * 1e3:.2f} us")
        # D's lower triangle read (the kernel reads no other entry), L and
        # L⁻¹ written whole; ~n³/3 FMAs for the factor and ~n³/6 for the
        # inverse, n³ float operations per block
        entries.append(kernel_entry(
            f"K3 48x48 diagonal-block factor and inverse ({Bt} blocks, "
            f"{how})", "waveome_tpu_torch/csrc/diag_factor.cu",
            "waveome_tpu/pallas_ops/chol_pallas.py:212", err, ms, plain_ms,
            4 * Bt * (nb * (nb + 1) // 2 + 2 * nb * nb), Bt * nb ** 3))
    check(entries[0]["ms"] < ex_ms[0],
          f"K3 at {B}x{nb}x{nb} is faster than cholesky_ex alone: "
          f"{entries[0]['ms'] * 1e3:.2f} us < {ex_ms[0] * 1e3:.2f} us")

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
    print(f"cholesky_hybrid {B}x{N}x{N}: {h_ms:.3f} ms (K2 {k2_ms:.3f} ms; "
          f"before K3's redesign: {PREVIOUS_MS['hybrid']:.2f} ms)")
    return entries


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


def prediction_chol_fails(config, params, cm, fm):
    """Per row: does the float32 Cholesky of the prediction's matrix,
    Kuu + jitter I under the final masks, fail on the tensors' device (K1
    and K2 on the card, the plain versions on the CPU)? The importances
    then fall back: the residual share reads 1.0 although nothing was
    predicted."""
    import torch

    from waveome_tpu_torch.config import default_jitter
    from waveome_tpu_torch.cuda_ops.chol_cuda import cholesky_forward
    from waveome_tpu_torch.kernels.gram import gram

    Z = params["z"]
    with torch.no_grad():
        K = gram(config.spec, params["kernel_raw"], Z, Z, cm, fm)
        K = K + default_jitter(K.dtype) * torch.eye(
            K.shape[-1], device=K.device)
        return torch.isnan(cholesky_forward(K)).any(-1).any(-1)


def fit_path(dev, label, X, Ys, kw, max_iter, cpu_rows, refit_rows,
             edge_rows, obj_rtol=OBJ_RTOL, imp_finite_min=IMP_FINITE_MIN):
    """fit_outcomes_penalized on the GPU (after a short warm-up), checked;
    then on the CPU through the plain versions: the objective, masks and
    importances of ``cpu_rows`` at the GPU's parameters, and
    ``refit_rows`` fitted from scratch. ``edge_rows``: the outcomes known to
    sit at float32's edge, the only ones whose scores may go uncompared.
    Returns (result, launches)."""
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
    if label in PREVIOUS_FIT:
        print(f"{label}, before the kernels' redesign (same card model and "
              f"power limit): {PREVIOUS_FIT[label]}")
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
    at = cpu_rows[int(torch.where(lost, -1.0, orel).argmax())]
    check(worst < obj_rtol and bool((lost == excused).all())
          and bool(torch.isfinite(gl).all()),
          f"{label}: CPU objective at the GPU's parameters (outcomes "
          f"{cpu_rows}): max rel diff {worst:.3g} < {obj_rtol} (at outcome "
          f"{at}); not "
          f"finite on the CPU for outcomes "
          f"{[cpu_rows[i] for i in torch.nonzero(lost).flatten().tolist()]}"
          f", each where the CPU's float32 Cholesky of the objective's "
          f"matrix fails: {bool((lost == excused).all())}")
    imp_g = r.importances.cpu()[sel]
    # a row whose prediction loses its float32 Cholesky on the CPU (the
    # plain versions) has fallback scores there (ROADMAP Queue 3): it is
    # named and compared no further, and it must be one of ``edge_rows``.
    # A factorization that K2 loses on the card excuses nothing: that row
    # is compared, and it is printed
    sel_d = sel.to(dev)
    lost_cpu = prediction_chol_fails(res.config, rows, cm_c, fm_c)
    lost_card = prediction_chol_fails(
        res.config, {k: v[sel_d] for k, v in r.params.items()},
        r.component_mask[sel_d], r.factor_mask[sel_d]).cpu()
    left_out = [cpu_rows[i]
                for i in torch.nonzero(lost_cpu).flatten().tolist()]
    both = torch.isfinite(imp_g) & torch.isfinite(imp_c) \
        & ~lost_cpu[:, None]
    # scores are rounded to 0.1, so rounding may split them by one step
    excess = (imp_g - imp_c).abs() - IMP_ATOL - IMP_RTOL * imp_c.abs()
    imp_err = float(excess[both].max()) if bool(both.any()) else 0.0
    same = bool((cm_c == r.component_mask.cpu()[sel]).all()
                and (fm_c == r.factor_mask.cpu()[sel]).all())
    at = int(torch.where(both, excess, -1.0).argmax())
    r_at, c_at = divmod(at, imp_g.shape[1])
    check(same and imp_err <= 0 and set(left_out) <= set(edge_rows),
          f"{label}: CPU masks and importances at the "
          f"GPU's parameters: same masks {same}; finite scores agree within "
          f"{IMP_ATOL} + {IMP_RTOL}*|score| ({int(both.all(1).sum())} of "
          f"{len(cpu_rows)} outcomes finite on both; furthest apart: outcome "
          f"{cpu_rows[r_at]}, score {c_at}, GPU {float(imp_g[r_at, c_at])}, "
          f"CPU {float(imp_c[r_at, c_at])}; left out, because the CPU's "
          f"float32 Cholesky of the prediction's Kuu + jitter I fails: "
          f"outcomes {left_out}, all among {list(edge_rows)}; K2 on the card "
          f"loses that factorization for outcomes "
          f"{[cpu_rows[i] for i in torch.nonzero(lost_card).flatten().tolist()]}"
          f", which stay in the comparison)")
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

    k1, k1w = gram_checks(dev)
    k2, k2s, A, A64, noise = chol_checks(dev)
    k3, k3s = diag_checks(dev, A, A64, noise)
    del A, A64
    k4 = harness_checks(dev)

    spec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                             return_sum=True)
    X, Ys = simulate(n_outcomes=EXACT_OUTCOMES)
    _, exact = fit_path(
        dev, "M = N path", X, Ys,
        dict(spec=spec, num_inducing_points=X.shape[0], num_factor_iter=0,
             dtype=torch.float32), 200, CPU_ROWS, CPU_ROWS, EDGE_ROWS)
    X, Ys = simulate(**SPARSE)
    # every argument but max_iter at its default: M = 500, 5 factor rounds
    _, sparse = fit_path(dev, "sparse path", X, Ys, dict(spec=spec), 200,
                         SPARSE_CPU_ROWS, SPARSE_REFIT_ROWS, SPARSE_EDGE_ROWS,
                         obj_rtol=SPARSE_OBJ_RTOL,
                         imp_finite_min=SPARSE_IMP_FINITE_MIN)
    optin = hybrid_optin(dev, X, Ys, spec)

    k3["launches"] = k3s["launches"] = optin["K3"]
    for k, name in ((k1, "K1"), (k1w, "K1"), (k2, "K2"), (k2s, "K2")):
        k["launches"] = sparse[name]
        k["launches_by_path"] = {"M = N": exact[name], "sparse": sparse[name],
                                 "hybrid opt-in": optin[name]}
    return [k1, k1w, k2, k2s, k3, k3s, k4]


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
