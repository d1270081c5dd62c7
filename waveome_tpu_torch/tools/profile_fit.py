"""Where the time of one penalized fit goes on the GPU.

    python -m waveome_tpu_torch.tools.profile_fit [--n-units 200]
        [--n-per 10] [--outcomes 256] [--inducing 500] [--factor-iter 5]
        [--max-iter 200]

Fits ``datasets.simulate`` outcomes with the saturated kernel in float32
on the CUDA device: one warm-up call, one timed call, then one call under
``torch.profiler``. Prints the card, the timed call's wall time, the
profiled call's device time summed over kernels and the device's idle
share of the profiled wall time, then the kernels by device time.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..cuda_ops import chol_cuda, diag_factor_cuda, gram_cuda
from ..datasets import simulate
from ..fit import fit_outcomes_penalized
from ..kernels import full_kernel_build


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-units", type=int, default=200)
    ap.add_argument("--n-per", type=int, default=10)
    ap.add_argument("--outcomes", type=int, default=256)
    ap.add_argument("--inducing", type=int, default=500)
    ap.add_argument("--factor-iter", type=int, default=5)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    X, Ys = simulate(args.n_units, args.n_per, args.outcomes)
    spec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                             return_sum=True)
    kw = dict(num_inducing_points=args.inducing,
              num_factor_iter=args.factor_iter, max_iter=args.max_iter,
              dtype=torch.float32, device="cuda")
    fit_outcomes_penalized(X, Ys[:, :8], spec, **dict(kw, max_iter=2))
    torch.cuda.synchronize()

    gram_cuda.launch_count = chol_cuda.launch_count = 0
    diag_factor_cuda.launch_count = 0
    t0 = time.perf_counter()
    res = fit_outcomes_penalized(X, Ys, spec, **kw).results
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{card}; N={X.shape[0]} M={min(args.inducing, X.shape[0])} "
          f"outcomes={args.outcomes} num_factor_iter={args.factor_iter}: "
          f"wall {wall:.3f} s, {args.outcomes / wall * 60:.1f} fits/min, "
          f"mean iters {float(res.num_iters.double().mean()):.1f}, factor "
          f"rounds {float(res.factor_rounds.double().mean()):.2f}, "
          f"launches K1 {gram_cuda.launch_count} K2 "
          f"{chol_cuda.launch_count}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fit_outcomes_penalized(X, Ys, spec, **kw)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
    if not kernels:  # profilers that file kernels under their CPU ops
        kernels = [e for e in events if _device_us(e) > 0]
    total = sum(_device_us(e) for e in kernels)
    print(f"profiled: wall {pwall:.3f} s, device time {total / 1e6:.3f} s, "
          f"device idle share {1 - total / 1e6 / pwall:.3f}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
        us = _device_us(e)
        print(f"  {100 * us / max(total, 1):5.1f} %  {us / 1e3:10.1f} ms  "
              f"{e.count:7d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
