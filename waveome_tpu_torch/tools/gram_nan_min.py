"""The gram-inside-an-optimizer-loop harness of the reference's
``tools/pallas_nan_min.py``, on this package's gram.

The reference built it to isolate a TPU miscompile: a one-component SE gram
as a Pallas call (``gram_pallas_raw``, its kernel K4) wrapped in a custom
VJP, inside a vmapped ``while_loop`` whose step updates one coordinate by
index assignment, gave NaN gradients after the first step. Here the same
composition runs through ``kernels.gram.gram`` (kernel K1 on CUDA tensors,
``GramFn``'s analytic backward) or through ``gram_plain``, over an explicit
batch of problems:

- B problems, x of shape (B, 128, D) from a seeded numpy generator;
- one SE component on column 0 of x (a wider x carries columns the gram
  must skip), its variance and lengthscale the softplus of two free
  coordinates;
- the objective ½‖L⁻¹(x[:, 0] − c)‖² + Σ log diag L, L = chol(K + 0.05 I),
  c the third free coordinate;
- ``steps`` gradient steps, step k moving coordinate k mod 3 by −0.1 × its
  gradient through index assignment; a problem whose gradient is not
  finite stops there, as the reference's loop does.

    python -m waveome_tpu_torch.tools.gram_nan_min [--cpu] [--plain]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.gram import gram, gram_plain
from ..kernels.spec import KernelSpec, Primitive
from ..linalg import cholesky

NOISE = 0.05


def run(D: int = 1, B: int = 4, N: int = 128, steps: int = 8,
        plain: bool = False, device=None, seed: int = 0):
    """Returns (iterations (B,), NaN-gradient flags (B,), iterates
    (steps + 1, B, 3)) of the harness in float32 on ``device`` (default:
    the CUDA device; without one this raises)."""
    dev = resolve_device(device, "gram_nan_min.run")
    x = torch.tensor(np.random.default_rng(seed).normal(size=(B, N, D)),
                     dtype=torch.float32, device=dev)
    spec = KernelSpec(((Primitive("squared_exponential", 0),),))
    gram_fn = gram_plain if plain else gram
    eye = torch.eye(N, dtype=x.dtype, device=dev)

    def objective(flat):
        zero = torch.zeros_like(flat[:, 0])
        raw = torch.stack([flat[:, 0], flat[:, 1], zero, zero], -1)
        K = gram_fn(spec, raw[:, None, None, :], x)
        L = cholesky(K + NOISE * eye)
        alpha = torch.linalg.solve_triangular(
            L, (x[..., 0] - flat[:, 2, None])[..., None], upper=False)
        return (0.5 * torch.sum(alpha ** 2, dim=(-2, -1))
                + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                            dim=-1))

    flat = torch.tensor([0.5, 0.3, 0.0], dtype=x.dtype,
                        device=dev).repeat(B, 1)
    its = torch.zeros(B, dtype=torch.int64, device=dev)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    history = [flat.clone()]
    for it in range(steps):
        active = ~bad
        xg = flat.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(objective(xg).sum(), xg)
        nan = ~torch.isfinite(g).all(dim=-1)
        idx = it % flat.shape[1]
        new = flat.clone()
        new[:, idx] = flat[:, idx] - 0.1 * g[:, idx]
        flat = torch.where((active & ~nan)[:, None], new, flat)
        its += active.to(its.dtype)
        bad |= active & nan
        history.append(flat.clone())
    return its, bad, torch.stack(history)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--plain", action="store_true",
                    help="gram_plain instead of GramFn")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    for D in (1, 2):
        its, bad, _ = run(D=D, plain=args.plain, device=device)
        print(f"D={D} {'plain' if args.plain else 'GramFn'} on {device}: "
              f"iters={its.tolist()} nan_grad={bad.tolist()}")


if __name__ == "__main__":
    main()
