"""Batched per-outcome penalized fitting (counterpart of
``waveome_tpu/fit/batch.py``: the segmented Gaussian branch, and the
automatic-factor pipeline that the reference vmaps over outcomes).

All outcomes sharing the saturated kernel are fitted at once: the outcome
axis is the leading batch dimension of every tensor, L-BFGS advances the
whole batch in segments, and rows that converged are dropped between
segments, so late stragglers do not drag the full batch width along.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import default_float, resolve_device
from ..kernels.gram import component_variances
from ..kernels.spec import KernelSpec
from ..linalg import cholesky, cholesky_hybrid, hybrid_supported
from ..models import svgp
from ..optimize.plbfgs import plbfgs_fit
from .penalized import (
    PenalizedFitResult,
    auto_penalization_factor,
    chunked,
    penalized_finalize,
    penalized_fit,
    with_optimal_q,
)

# Iterations per segment. The host reads the convergence flags once per
# segment to compact the batch; results do not depend on this value.
SEGMENT_ITERS = 10
# float32 only: a smooth barrier keeps component variances below this cap,
# where float32 marginal-likelihood noise would dwarf real changes
_VAR_CAP = 1e3
# Live-memory budget of one finalize chunk (optimal q, predictions and the
# leave-one-component-out importances)
_CHUNK_BYTES = 2 << 30
_ROADMAP = "ROADMAP Queue 1, Slice A, 'still to port': "


class BatchFitResult(NamedTuple):
    config: object
    results: PenalizedFitResult  # leading axis = outcomes
    num_outcomes: int

    def for_outcome(self, i: int) -> PenalizedFitResult:
        r = self.results
        return PenalizedFitResult(
            params={k: v[i] for k, v in r.params.items()},
            **{f: getattr(r, f)[i] for f in r._fields if f != "params"})


def fit_outcomes_penalized(
    X,
    Ys,
    spec: KernelSpec,
    likelihood: str = "gaussian",
    num_inducing_points: int = 500,
    penalization_factor: Optional[float] = None,
    num_factor_iter: int = 5,
    num_restart: int = 0,
    max_iter: int = 500,
    var_cutoff: float = 0.1,
    importance_type: str = "log_bf",
    use_mesh: bool = False,
    compute_importances: bool = True,
    dtype: Optional[torch.dtype] = None,
    objective: str = "auto",
    batch_size: Optional[int] = None,
    device=None,
    seed: int = 0,
    hybrid_trial_cholesky: bool = False,
) -> BatchFitResult:
    """Fit every column of ``Ys`` (N, B) over the design ``X`` (N, D) with
    the horseshoe-penalized Gaussian model, prune, and score the
    components; on ``device`` (default: the CUDA device; without one this
    raises) in ``dtype`` (default ``config.default_float()``).

    The objective is the exact marginal likelihood when the inducing
    points are all the data (M = N), else the collapsed bound with M
    inducing points drawn from the rows of X without replacement by a
    ``torch.Generator`` seeded with ``seed`` (on the CPU, so every device
    draws the same Z) and trained with the hyperparameters. With
    ``penalization_factor=None`` the factor is automatic: σ̂ = 1 when
    ``num_factor_iter`` is 0, else σ̂ = std(y) re-estimated up to
    ``num_factor_iter`` times from the fitted residual scale.

    ``hybrid_trial_cholesky``: with ``num_factor_iter=0``, the line
    search's trial factorizations (not the gradient's) go through
    ``linalg.cholesky_hybrid`` with kernel K3, where M is in
    ``hybrid_supported``; the factor iteration ignores it, as the
    reference's does. Off by default: its explicit-inverse panel solve
    loses accuracy on real grams.

    Likelihoods other than the Gaussian, restarts, minibatches, the
    iterative objective and a device mesh raise ``NotImplementedError``
    naming their ROADMAP item.
    """
    if use_mesh:
        raise NotImplementedError(
            "a device mesh is not ported yet (ROADMAP Queue 1 item 19, "
            "'Multi-GPU and entry points')")
    if num_restart:
        raise NotImplementedError(_ROADMAP + "random restarts")
    if batch_size is not None:
        raise NotImplementedError(_ROADMAP + "minibatch training")
    if objective == "iterative":
        raise NotImplementedError(
            "objective='iterative' is not ported yet (ROADMAP Queue 1 item "
            "16, 'models/iterative.py')")
    if objective not in ("auto", "cholesky"):
        raise ValueError(f"unknown objective {objective!r}")

    dtype = dtype or default_float()
    device = resolve_device(device, "fit_outcomes_penalized")
    X_np = np.asarray(X, dtype=np.float64)
    Ys_np = np.asarray(Ys, dtype=np.float64)
    N, B = Ys_np.shape
    config = svgp.make_config(spec, likelihood, num_data=N,
                              input_dim=X_np.shape[1],
                              num_inducing_points=num_inducing_points)

    gen = torch.Generator().manual_seed(seed)
    params0 = svgp.init_params(config, X_np, generator=gen, dtype=dtype,
                               device=device)
    X_dev = torch.as_tensor(X_np, dtype=dtype, device=device)
    Ys_dev = torch.as_tensor(Ys_np.T[:, :, None], dtype=dtype, device=device)
    p0 = {k: v.expand((B,) + v.shape) for k, v in params0.items()}
    M, C = config.num_inducing, config.num_components
    iterate = num_factor_iter > 0
    # the reference's forward_pallas trials exist only on its segmented
    # branch (num_factor_iter = 0); its penalized_fit never routes to K3
    trial_chol = (cholesky_hybrid if hybrid_trial_cholesky and not iterate
                  and hybrid_supported(M) else None)
    # rows per finalize chunk: ~6 live (rows·(C+1), M, N) temporaries in
    # the leave-one-out predictions (Kuf, A, S·A and their products)
    per_row = 6 * (C + 1) * M * N * torch.finfo(dtype).bits // 8
    chunk = max(1, min(B, _CHUNK_BYTES // per_row))

    if penalization_factor is not None:
        factors = torch.full((B,), float(penalization_factor), dtype=dtype,
                             device=device)
    else:
        sigma_hat = (torch.std(Ys_dev[..., 0], dim=-1) if iterate
                     else torch.ones(B, dtype=dtype, device=device))
        factors = auto_penalization_factor(
            sigma_hat, N, spec.num_variance_prior_params()).to(dtype)

    def fit(p, ys, fac):
        # penalized_fit passes ftol 1e-9 in float64; the segmented branch
        # keeps plbfgs's default of 1e-6
        ftol = 1e-9 if iterate and dtype == torch.float64 else 1e-6
        return _segmented_gaussian_fit(config, p, X_dev, ys, fac, max_iter,
                                       ftol=ftol, trial_chol=trial_chol)

    if iterate and penalization_factor is None:
        params, factors, loss, num_iters, rounds = penalized_fit(
            config, p0, X_dev, Ys_dev, factors, fit, num_factor_iter, chunk)
    else:
        params, loss, num_iters = fit(p0, Ys_dev, factors)
        params = with_optimal_q(config, params, X_dev, Ys_dev, chunk)
        rounds = torch.zeros_like(num_iters)

    def finalize(lo, hi):
        return penalized_finalize(
            config, {k: v[lo:hi] for k, v in params.items()}, X_dev,
            Ys_dev[lo:hi], var_cutoff=var_cutoff,
            importance_type=importance_type,
            compute_importances=compute_importances)

    component_mask, factor_mask, importances = chunked(finalize, B, chunk)
    results = PenalizedFitResult(
        params=params,
        penalization_factor=factors,
        component_mask=component_mask,
        factor_mask=factor_mask,
        importances=importances,
        loss=loss,
        num_iters=num_iters,
        factor_rounds=rounds,
    )
    return BatchFitResult(config=config, results=results, num_outcomes=B)


def penalized_objective(config, params, X, Y, factor, chol=cholesky):
    """The fit's loss per row: −(exact MLL when M = N, else the collapsed
    bound, + horseshoe prior), plus in float32 the variance barrier
    Σ relu(v − 1e3)². ``chol`` factors the objective's matrices."""
    fitobj = (svgp.exact_mll if config.num_inducing >= X.shape[-2]
              else svgp.collapsed_elbo)
    obj = (fitobj(config, params, X, Y, chol=chol)
           + svgp.log_prior_density(config, params, factor))
    if X.dtype == torch.float32:
        v = component_variances(config.spec, params["kernel_raw"])
        obj = obj - torch.sum(torch.relu(v - _VAR_CAP) ** 2, dim=-1)
    return -obj


def _segmented_gaussian_fit(config, params0, X, Ys, factors, max_iter: int,
                            ftol: float = 1e-6, trial_chol=None):
    """Segmented L-BFGS over the penalized objective of every outcome, with
    batch compaction between segments, from the batched start parameters
    ``params0`` (leaves (B, ...)). The hyperparameters train, and Z too
    when M < N; q is closed-form and stays. ``trial_chol``, when given,
    factors the line-search trials' matrices. Returns (fitted params
    (B, ...), loss (B,), num_iters (B,))."""
    B = Ys.shape[0]
    tol = 3e-5 if X.dtype == torch.float32 else 1e-8
    mask = svgp.train_mask_np(config)
    for k in ("q_mu", "q_sqrt_raw"):
        mask[k] = np.zeros_like(mask[k])
    if config.num_inducing >= X.shape[-2]:  # Z = X frozen on the exact path
        mask["z"] = np.zeros_like(mask["z"])
    free_keys = [k for k in mask if mask[k].any()]
    # the reference's large-M memory guard: trials one at a time
    sequential = config.num_inducing >= 2048

    def run(ys, fac, p, bound, carry=None):
        def loss(q):
            return penalized_objective(config, q, X, ys, fac)

        def trial_loss(q):
            return penalized_objective(config, q, X, ys, fac,
                                       chol=trial_chol)
        return plbfgs_fit(loss, p, mask, bound, tol=tol, carry=carry,
                          ftol=ftol,
                          trial_loss_fn=None if trial_chol is None
                          else trial_loss,
                          trial_sequential=sequential)

    bound = min(SEGMENT_ITERS, max_iter)
    res, carry = run(Ys, factors, params0, bound)
    params = {k: (res.params[k].clone() if k in free_keys
                  else res.params[k]) for k in res.params}
    loss, num_iters = res.loss.clone(), res.num_iters.clone()
    rows = torch.arange(B, device=X.device)  # batch position → outcome
    ys, fac, p_cur = Ys, factors, params0
    while bound < max_iter:
        # rows still running: not converged, and not stopped early (by a
        # non-finite gradient) in this segment; one host read
        running = ~res.converged & (res.num_iters >= bound)
        active = torch.nonzero(running).flatten()
        if active.numel() == 0:
            break
        if active.numel() < rows.numel():
            carry = carry.take(active)
            ys, fac, rows = ys[active], fac[active], rows[active]
            p_cur = {k: v[active] for k, v in p_cur.items()}
        bound = min(bound + SEGMENT_ITERS, max_iter)
        res, carry = run(ys, fac, p_cur, bound, carry)
        for k in free_keys:
            params[k][rows] = res.params[k]
        loss[rows] = res.loss
        num_iters[rows] = res.num_iters
    return params, loss, num_iters
