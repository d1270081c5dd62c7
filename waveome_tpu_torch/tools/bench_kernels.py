"""Times of kernels K1 (gram), K2 (Cholesky) and K3 (diagonal-block
factor) alone, for one or more directories of kernel sources, on the CUDA
device.

    python -m waveome_tpu_torch.tools.bench_kernels
        [--variant NAME=CSRC_DIR]... [--reps 10]

Without ``--variant`` it times the package's own sources. Each variant is
a directory of kernel sources with the same C interface (for example the
parent commit's ``csrc`` unpacked from ``git archive``, or a scratch copy
with a part of a kernel taken out). The variants are timed in turns,
forwards then backwards, inside one process and so on one card. Per
variant: the registers and spills that ``-Xptxas -v`` reports, K2 at
1024x500x500 and 256x500x500 (RBF grams + sigma^2 I) with ``cholesky_ex``
beside it and its residual against the input, K1 at 1024x500x500 (shared
design) and 1024x500x2000 (a design per parameter set on the rows) with
its error against ``gram_plain`` on a slice, K3 at 1024x48x48 and
256x48x48 through the contiguous entry that every tree of sources has (with
``cholesky_ex`` alone beside it, which gives L without L^-1), and the
hybrid Cholesky at 1024x500x500: composed as before the strided entry, each
diagonal block copied to a contiguous batch and L11 copied back, and, where
the variant has the strided entry, as ``linalg.cholesky_hybrid`` runs it,
in place. A ``fill_`` of 1 GB is timed for scale.

A variant whose library exports ``waveome_k3_clocks(unsigned long long
out[8], int reset)`` (a scratch copy of ``csrc/`` with ``clock64()`` counters
summed by lane 0 of each warp into slots 0-4 at the ends of K3's five
phases, and the warps counted in slot 7) also gets K3's clocks per warp by
phase at B = 1, 256 and 1024.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import time

import numpy as np
import torch

from ..cuda_ops import _lib, chol_cuda, diag_factor_cuda, gram_cuda
from ..datasets import simulate
from ..kernels import full_kernel_build
from ..kernels.gram import gram_plain
from ..linalg import cholesky_hybrid


def cuda_ms(fn, reps, spin=True):
    """Mean milliseconds of fn() on the card (CUDA events, after warm-up).
    The timed launches queue behind a spin of the device
    (``torch.cuda._sleep``) that outlasts the host's time to issue them, so
    that a kernel shorter than its Python launch path is timed back to back
    on the device and not at the host's pace (``spin=False``: at the
    host's pace, as a caller that launches one at a time sees it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0  # host and device, an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(min(1.5 * per_call * reps, 0.2) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def use_variant(csrc):
    """Point the kernel library at another build; returns its -Xptxas log."""
    _lib.CSRC, _lib._lib = csrc, None
    _lib.build_log = None
    _lib.library()
    return _lib.build_log


def rbf_grams(B, N, dev):
    rng = np.random.default_rng(0)
    x = np.sort(rng.normal(size=N))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.3 ** 2)
    noise = np.where(np.arange(B) % 2 == 0, 0.05, 1.0)
    return torch.tensor(K[None] + noise[:, None, None] * np.eye(N),
                        dtype=torch.float32, device=dev)


def hybrid_with_copies(A, blk=diag_factor_cuda.NB):
    """cholesky_hybrid as it was composed before K3 took strided views:
    each diagonal block copied to a contiguous batch, L11 copied into the
    factor (two copy launches per block step)."""
    N = A.shape[-1]
    Np = N + (-N) % blk
    W = A.new_zeros((A.shape[0], Np, Np))
    W[:, :N, :N] = A
    W[:, N:, N:] = torch.eye(Np - N, dtype=A.dtype, device=A.device)
    L = torch.zeros_like(W)
    for o in range(0, Np, blk):
        e = o + blk
        L11, inv11 = diag_factor_cuda.diag_factor_cuda(
            W[:, o:e, o:e].contiguous())
        L[:, o:e, o:e] = L11
        if e == Np:
            break
        A21 = W[:, e:, o:e]
        P = A21 @ inv11.mT
        P = P + (A21 - P @ L11.mT) @ inv11.mT
        L[:, e:, o:e] = P
        W[:, e:, e:].baddbmm_(P, P.mT, alpha=-1.0)
    return L[:, :N, :N]


K3_PHASES = ("load", "factor", "L out", "inverse", "L^-1 out")


def k3_clocks(lib, D):
    """K3's clock64() counts per warp by phase, from a library that has
    the counters (see the module's docstring)."""
    fn = lib.waveome_k3_clocks
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 8)()
    for B in (1, 256, 1024):
        _lib.check(fn(buf, 1), "waveome_k3_clocks")
        diag_factor_cuda.diag_factor_cuda(D[:B])
        torch.cuda.synchronize()
        _lib.check(fn(buf, 1), "waveome_k3_clocks")
        per = [buf[i] / buf[7] for i in range(len(K3_PHASES))]
        print(f"  K3 clocks per warp at B={B}: " + ", ".join(
            f"{n} {c:.0f}" for n, c in zip(K3_PHASES, per))
            + f"; total {sum(per):.0f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    variants = [v.split("=", 1)
                for v in args.variant or [f"tree={_lib.CSRC}"]]

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    A = rbf_grams(1024, 500, dev)
    spec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                             return_sum=True)
    g = torch.Generator().manual_seed(0)
    X = torch.tensor(simulate(n_outcomes=1)[0], dtype=torch.float32,
                     device=dev)
    X2 = torch.tensor(simulate(200, 10, 1)[0], dtype=torch.float32,
                      device=dev)
    base = torch.tensor(spec.init_raw_params_np(), dtype=torch.float32)
    raw = (base + 0.3 * torch.randn(1024, *base.shape, generator=g)).to(dev)
    Z = X[None] + 0.01 * torch.randn(1024, *X.shape, generator=g).to(dev)
    want = gram_plain(spec, raw[:64], X)
    want_z = gram_plain(spec, raw[:16], Z[:16], X2)

    for B in (1024, 256):
        ms = cuda_ms(lambda: torch.linalg.cholesky_ex(A[:B]), args.reps)
        print(f"cholesky_ex {B}x500x500: {ms:.3f} ms")
    D = A[:, :48, :48].contiguous()
    want_d = diag_factor_cuda.diag_factor_plain(D)
    for B in (1024, 256):
        ms = cuda_ms(lambda: torch.linalg.cholesky_ex(D[:B]), 20 * args.reps)
        print(f"cholesky_ex alone {B}x48x48: {ms * 1e3:.2f} us")
    buf = torch.empty(1024 * 500 * 500, device=dev)
    print(f"fill_ of 1 GB: {cuda_ms(lambda: buf.fill_(1.0), args.reps):.3f} "
          f"ms")
    del buf

    for name, csrc in variants + variants[::-1]:
        log = use_variant(csrc)
        print(f"== {name}: {csrc}")
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())
        L = chol_cuda.cholesky_cuda(A)
        resid = float((torch.linalg.matrix_norm(
            L.double() @ L.double().mT - A.double())
            / torch.linalg.matrix_norm(A.double())).max())
        for B in (1024, 256):
            ms = cuda_ms(lambda: chol_cuda.cholesky_cuda(A[:B]), args.reps)
            print(f"  K2 {B}x500x500: {ms:.3f} ms (max residual {resid:.3g})")
        err = float((gram_cuda.gram_forward(spec, raw[:64], X, X) - want)
                    .abs().max() / want.abs().max())
        ms = cuda_ms(lambda: gram_cuda.gram_forward(spec, raw, X, X),
                     args.reps)
        print(f"  K1 1024x500x500: {ms:.3f} ms (rel err {err:.3g})")
        err = float((gram_cuda.gram_forward(spec, raw[:16], Z[:16], X2)
                     - want_z).abs().max() / want_z.abs().max())
        ms = cuda_ms(lambda: gram_cuda.gram_forward(spec, raw, Z, X2),
                     max(args.reps // 2, 1))
        print(f"  K1 1024x500x2000, a design per set: {ms:.3f} ms "
              f"(rel err {err:.3g})")
        got = diag_factor_cuda.diag_factor_cuda(D)
        err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want_d))
        for B in (1024, 256):
            ms, host_ms = (cuda_ms(
                lambda: diag_factor_cuda.diag_factor_cuda(D[:B]),
                20 * args.reps, spin) for spin in (True, False))
            print(f"  K3 {B}x48x48: {ms * 1e3:.2f} us (at the host's pace "
                  f"{host_ms * 1e3:.2f} us; rel err {err:.3g})")
        if hasattr(_lib.library(), "waveome_k3_clocks"):
            k3_clocks(_lib.library(), D)
        ms = cuda_ms(lambda: hybrid_with_copies(A), args.reps)
        print(f"  hybrid 1024x500x500, blocks copied: {ms:.3f} ms")
        if hasattr(_lib.library(), "waveome_diag_factor_strided"):
            ms = cuda_ms(lambda: cholesky_hybrid(A), args.reps)
            print(f"  hybrid 1024x500x500, in place: {ms:.3f} ms")


if __name__ == "__main__":
    main()
