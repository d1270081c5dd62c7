"""Penalization factor, its automatic re-estimation, pruning and the
finalize stage of the penalized fit (counterpart of
``waveome_tpu/fit/penalized.py``).

``penalized_fit`` is the reference's per-outcome pipeline, batched over
outcomes: the reference vmaps a ``while_loop`` over the factor rounds; here
each row carries a ``done`` flag and only the rows still open are refitted.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..interpret.importance import feature_importance
from ..kernels.gram import component_variances, constrain
from ..models import svgp


class PenalizedFitResult(NamedTuple):
    params: dict
    penalization_factor: torch.Tensor
    component_mask: torch.Tensor  # (..., C) 0/1 after pruning
    factor_mask: torch.Tensor  # (..., C, F) 0/1 after lengthscale pruning
    importances: torch.Tensor  # (..., C+1) incl. residual share
    loss: torch.Tensor
    num_iters: torch.Tensor  # iterations of the first fit, as the reference
    factor_rounds: torch.Tensor  # refits with a re-estimated factor


def auto_penalization_factor(sigma_hat, n_obs, num_var_components):
    """2·1.1·σ̂·√N·Φ⁻¹(1 − 0.1/(2p)), in float64."""
    p = torch.as_tensor(num_var_components, dtype=torch.float64)
    return (2.0 * 1.1 * torch.as_tensor(sigma_hat, dtype=torch.float64)
            * torch.sqrt(torch.as_tensor(n_obs, dtype=torch.float64))
            * torch.special.ndtri(1.0 - 0.1 / (2.0 * p)))


def chunked(fn, B: int, chunk: int):
    """fn(lo, hi) over row chunks of at most ``chunk``, outputs concatenated
    (each output a tensor or a dict of tensors)."""
    parts = [fn(lo, min(lo + chunk, B)) for lo in range(0, B, chunk)]
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return tuple(torch.cat(ps) for ps in zip(*parts))


def with_optimal_q(config, params, X, Ys, chunk: int) -> dict:
    """``params`` with the closed-form optimal (q_mu, q_sqrt) of every row,
    in chunks of rows that bound live memory."""
    def part(lo, hi):
        p = {k: v[lo:hi] for k, v in params.items()}
        q_mu, q_sqrt = svgp.optimal_q(config, p, X, Ys[lo:hi])
        return dict(p, q_mu=q_mu, q_sqrt_raw=q_sqrt)
    return chunked(part, Ys.shape[0], chunk)


def next_factor(config, params, X, factor, chunk: int):
    """The reference's re-estimated factor from the fitted residual scale,
    σ̂ = √mean(predict_y variance), and its stop test: stop when the new
    factor is within 1e-3 of ``factor`` or larger. Returns (nf, stop)."""
    N = X.shape[-2]
    num_var = config.spec.num_variance_prior_params()

    def part(lo, hi):
        p = {k: v[lo:hi] for k, v in params.items()}
        _, yvar = svgp.predict_y(config, p, X)
        return (torch.sqrt(torch.mean(yvar[..., 0], dim=-1)),)
    (new_sd,) = chunked(part, factor.shape[0], chunk)
    nf = auto_penalization_factor(new_sd, N, num_var).to(factor.dtype)
    return nf, (torch.abs(nf - factor) <= 1e-3) | (nf > factor)


def penalized_fit(config, params0, X, Ys, factor0, fit: Callable,
                  num_factor_iter: int, chunk: int):
    """The automatic-factor fit of every outcome (``penalized_fit`` with
    ``num_factor_iter > 0``, waveome_tpu/fit/penalized.py:243-279).

    ``fit(params, Ys, factors)`` → (params, loss, num_iters) fits the given
    rows from their own start parameters with a fresh L-BFGS history.
    After the first fit and after each refit, optimal q is materialised and
    the next factor computed; a row stops when ``next_factor`` says so (the
    test runs before each refit, so a stopped row keeps the parameters,
    factor and loss of its last fit) or after ``num_factor_iter`` refits.
    A stopped row never moves again. Returns (params, factor, loss,
    num_iters of the first fit, factor rounds), each over the B rows.
    """
    params, loss, num_iters = fit(params0, Ys, factor0)
    params = {k: v.contiguous() for k, v in
              with_optimal_q(config, params, X, Ys, chunk).items()}
    factor = factor0.clone()
    nf, done = next_factor(config, params, X, factor, chunk)
    rounds = torch.zeros_like(num_iters)
    for _ in range(num_factor_iter):
        rows = torch.nonzero(~done).flatten()  # one host read per round
        if rows.numel() == 0:
            break
        p_r = {k: v[rows] for k, v in params.items()}
        p_r, loss_r, _ = fit(p_r, Ys[rows], nf[rows])
        p_r = with_optimal_q(config, p_r, X, Ys[rows], chunk)
        nf_r, stop_r = next_factor(config, p_r, X, nf[rows], chunk)
        for k in params:
            params[k][rows] = p_r[k]
        factor[rows] = nf[rows]
        loss[rows] = loss_r
        nf[rows], done[rows] = nf_r, stop_r
        rounds[rows] += 1
    return params, factor, loss, num_iters, rounds


def prune_masks(config, params, X, var_cutoff: float = 0.1):
    """Component pruning as masks: keep components whose variance is at
    least ``var_cutoff``; within them drop factors whose lengthscale
    exceeds 3× the range of their input column. Returns
    (component_mask (..., C), factor_mask (..., C, F))."""
    spec = config.spec
    raw = params["kernel_raw"]
    comp_keep = (component_variances(spec, raw) >= var_cutoff).to(X.dtype)
    ls_mask = torch.as_tensor(spec.lengthscale_mask(), device=X.device)
    active = torch.as_tensor(spec.active_factor_mask(), device=X.device)
    ls = constrain(raw)[..., 1]  # (..., C, F)
    ranges = torch.amax(X, dim=0) - torch.amin(X, dim=0)  # (D,)
    dims = torch.as_tensor(spec.coded_np()["dims"], dtype=torch.long,
                           device=X.device)
    fac_range = 3.0 * ranges[dims]
    ls_keep = torch.where(ls_mask, ls < fac_range, True)
    factor_mask = (active & ls_keep).to(X.dtype) * comp_keep[..., None]
    component_mask = (torch.amax(factor_mask, dim=-1) > 0).to(X.dtype)
    return component_mask, factor_mask


def penalized_finalize(config, params, X, Y, var_cutoff: float = 0.1,
                       importance_type: str = "log_bf",
                       compute_importances: bool = True):
    """Pruning + importances for fitted params (batched over ``...``)."""
    component_mask, factor_mask = prune_masks(config, params, X, var_cutoff)
    if compute_importances:
        importances = feature_importance(
            config, params, X, Y, component_mask=component_mask,
            factor_mask=factor_mask, return_value=importance_type)
    else:
        importances = torch.zeros(
            component_mask.shape[:-1] + (config.num_components + 1,),
            dtype=X.dtype, device=X.device)
    return component_mask, factor_mask, importances
