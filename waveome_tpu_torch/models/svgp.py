"""Sparse variational GP and the Gaussian objectives (exact marginal
likelihood, collapsed bound) as functions over a parameter dict
(counterpart of ``waveome_tpu/models/svgp.py``).

A model is a static ``SVGPConfig`` plus a dict of tensors:
``kernel_raw`` (..., C, F, 4), ``mean_c`` (..., 1), ``lik_raw``
(..., n_lik), ``q_mu`` (..., M, 1), ``q_sqrt_raw`` (..., M, M) and ``z``
(..., M, D). Every function carries the leading batch dimensions ``...``
through (outcomes, or line-search trials × outcomes); data ``X`` (N, D) is
shared and ``Y`` (..., N, 1) broadcasts against the parameters.

Math is the whitened SVGP of the reference: with L = chol(Kuu) and
A = L⁻¹ Kuf, q(f) = N(Aᵀ q_mu + m(X), Kff − AᵀA + Aᵀ S A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..bijectors import to_tril
from ..config import default_float, default_jitter
from ..kernels.gram import constrain, gram, gram_diag
from ..kernels.spec import KernelSpec
from ..likelihoods import Likelihood, gp_likelihood_crosswalk
from ..linalg import cholesky
from ..priors import horseshoe_log_prob

PARAM_KEYS = ("kernel_raw", "lik_raw", "mean_c", "q_mu", "q_sqrt_raw", "z")

_NOT_PORTED_GRAMS = ("the coded and banked grams are not ported yet "
                     "(ROADMAP Queue 1 item 10, 'Coded grams')")


@dataclasses.dataclass(frozen=True)
class SVGPConfig:
    """Static model description (hashable)."""

    spec: KernelSpec
    likelihood: Likelihood
    num_inducing: int
    input_dim: int
    train_inducing: bool = False
    mean_function: str = "constant"  # "constant" | "zero"

    @property
    def num_components(self) -> int:
        return self.spec.padded().num_components


def make_config(
    spec: KernelSpec,
    likelihood: str = "gaussian",
    num_data: int = 0,
    input_dim: int = 1,
    num_inducing_points: int = 500,
    train_inducing: bool = True,
    coded_structure: bool = False,
) -> SVGPConfig:
    """Inducing-point sizing of the reference's SparseGP: if M ≥ N use all
    data and freeze it."""
    if coded_structure:
        raise NotImplementedError(_NOT_PORTED_GRAMS)
    lik = (likelihood if isinstance(likelihood, Likelihood)
           else gp_likelihood_crosswalk(likelihood))
    M = min(num_inducing_points, num_data) if num_data else num_inducing_points
    if num_data and num_inducing_points >= num_data:
        train_inducing = False
    return SVGPConfig(spec=spec, likelihood=lik, num_inducing=M,
                      input_dim=input_dim, train_inducing=train_inducing)


def init_params(config: SVGPConfig, X, generator: Optional[torch.Generator]
                = None, dtype: Optional[torch.dtype] = None,
                device=None) -> dict:
    """Unbatched initial parameters: inducing points are all data when
    M == N, else a random subset drawn with ``generator``; q_mu = 0,
    q_sqrt = I (the gpflow defaults)."""
    dtype = dtype or default_float()
    X = torch.as_tensor(X, dtype=dtype, device=device)
    N = X.shape[0]
    M = config.num_inducing
    if M >= N:
        Z = X[:M]
    else:
        idx = torch.randperm(N, generator=generator)[:M]
        Z = X[idx.to(X.device)]
    kw = dict(dtype=dtype, device=X.device)
    return {
        "kernel_raw": torch.as_tensor(config.spec.init_raw_params_np(), **kw),
        "mean_c": torch.zeros((1,), **kw),
        "lik_raw": torch.as_tensor(config.likelihood.init_raw_np(), **kw),
        "q_mu": torch.zeros((M, 1), **kw),
        "q_sqrt_raw": torch.eye(M, **kw),
        "z": Z,
    }


def train_mask_np(config: SVGPConfig) -> dict:
    """Static numpy mask of trainable entries, per leaf (unbatched shape)."""
    M = config.num_inducing
    return {
        "kernel_raw": config.spec.train_mask_np(),
        "mean_c": np.full((1,), config.mean_function == "constant"),
        "lik_raw": np.ones((config.likelihood.n_params,), dtype=bool),
        "q_mu": np.ones((M, 1), dtype=bool),
        "q_sqrt_raw": np.tril(np.ones((M, M), dtype=bool)),
        "z": np.full((M, config.input_dim), config.train_inducing,
                     dtype=bool),
    }


def params_from_jax(np_params: dict, device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's parameter dict (numpy arrays, with or without a
    leading batch axis) as this package's tensors. The leaf layouts are the
    same: ``kernel_raw`` (C, F, 4), ``mean_c`` (1,), ``lik_raw`` (n,),
    ``q_mu`` (M, 1), ``q_sqrt_raw`` (M, M), ``z`` (M, D)."""
    if set(np_params) != set(PARAM_KEYS):
        raise ValueError(f"expected keys {sorted(PARAM_KEYS)}, got "
                         f"{sorted(np_params)}")
    dtype = dtype or default_float()
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in np_params.items()}


def _K(config, params, X1, X2=None, component_mask=None, coded=None,
       factor_mask=None, banks=None):
    if coded is not None or banks is not None:
        raise NotImplementedError(_NOT_PORTED_GRAMS)
    return gram(config.spec, params["kernel_raw"], X1, X2, component_mask,
                factor_mask)


def _Kdiag(config, params, X, component_mask=None, coded=None,
           factor_mask=None, banks=None):
    if coded is not None or banks is not None:
        raise NotImplementedError(_NOT_PORTED_GRAMS)
    return gram_diag(config.spec, params["kernel_raw"], X, component_mask,
                     factor_mask)


def _mean(config, params, X):
    """(..., N, 1) prior mean at X."""
    c = params["mean_c"]
    if config.mean_function == "constant":
        return c[..., None, :].expand(*c.shape[:-1], X.shape[-2], 1)
    return torch.zeros(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)


def _chol(K):
    """Every factorization on the path: kernel K2 on CUDA tensors."""
    return cholesky(K)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _conditional(config, params, Xnew, component_mask=None, coded=None,
                 full_cov: bool = False, factor_mask=None):
    """Whitened SVGP conditional q(f(Xnew)) → (mean (..., N, 1),
    var (..., N, 1) or cov (..., N, N))."""
    Z = params["z"]
    M = Z.shape[-2]
    Kuu = _K(config, params, Z, Z, component_mask, coded, factor_mask)
    Kuu = Kuu + default_jitter(Kuu.dtype) * _eye(M, Kuu)
    Kuf = _K(config, params, Z, Xnew, component_mask, coded, factor_mask)
    L = _chol(Kuu)
    A = torch.linalg.solve_triangular(L, Kuf, upper=False)  # (..., M, N)
    q_mu = params["q_mu"]
    q_sqrt = to_tril(params["q_sqrt_raw"])
    At = A.transpose(-1, -2)
    fmean = At @ q_mu + _mean(config, params, Xnew)
    SA = q_sqrt.transpose(-1, -2) @ A
    if full_cov:
        Kff = _K(config, params, Xnew, Xnew, component_mask, coded,
                 factor_mask)
        return fmean, Kff - At @ A + SA.transpose(-1, -2) @ SA
    Kdiag = _Kdiag(config, params, Xnew, component_mask, coded, factor_mask)
    fvar = Kdiag - torch.sum(A * A, dim=-2) + torch.sum(SA * SA, dim=-2)
    return fmean, fvar[..., None]


def kl_whitened(params):
    """KL(q(u) ‖ N(0, I)) for whitened q with lower-triangular q_sqrt."""
    q_mu = params["q_mu"]
    Lq = to_tril(params["q_sqrt_raw"])
    M = q_mu.shape[-2]
    mahal = torch.sum(q_mu ** 2, dim=(-2, -1))
    trace = torch.sum(Lq ** 2, dim=(-2, -1))
    # |diag| floored: a zero-crossing diagonal gives a large finite KL
    diag = torch.clamp(torch.abs(torch.diagonal(Lq, dim1=-2, dim2=-1)),
                       min=1e-150)
    logdet = 2.0 * torch.sum(torch.log(diag), dim=-1)
    return 0.5 * (mahal + trace - M - logdet)


def elbo(config: SVGPConfig, params, X, Y, component_mask=None, coded=None,
         scale: float = 1.0, factor_mask=None):
    """Evidence lower bound (gpflow SVGP.elbo semantics)."""
    fmean, fvar = _conditional(config, params, X, component_mask, coded,
                               factor_mask=factor_mask)
    lik_p = config.likelihood.constrain(params["lik_raw"])
    ve = config.likelihood.variational_expectations(
        lik_p, fmean[..., 0], fvar[..., 0], Y[..., 0])
    return scale * torch.sum(ve, dim=-1) - kl_whitened(params)


def log_prior_density(config: SVGPConfig, params, penalization_factor=0.0):
    """Horseshoe(1/λ) prior over the trainable kernel variances;
    ``penalization_factor`` is a number or a tensor broadcasting against
    the batch dimensions."""
    raw = params["kernel_raw"]
    zero = torch.zeros(raw.shape[:-3], dtype=raw.dtype, device=raw.device)
    if penalization_factor is None:
        return zero
    if isinstance(penalization_factor, (int, float)) and (
            penalization_factor <= 0):
        return zero  # no-penalty path: avoids inf-scale NaN gradients
    factor = torch.as_tensor(penalization_factor, dtype=raw.dtype,
                             device=raw.device)
    safe_factor = torch.clamp(factor, min=1e-30)
    mask = torch.as_tensor(config.spec.variance_prior_mask(),
                           device=raw.device)
    variances = constrain(raw)[..., 0]  # (..., C, F)
    lp = horseshoe_log_prob(variances, (1.0 / safe_factor)[..., None, None])
    total = torch.sum(torch.where(mask, lp, 0.0), dim=(-2, -1))
    return torch.where(factor > 0, total, 0.0)


def log_posterior(config: SVGPConfig, params, X, Y, penalization_factor=0.0,
                  component_mask=None, coded=None, scale: float = 1.0,
                  factor_mask=None):
    """ELBO + prior log-density."""
    return elbo(config, params, X, Y, component_mask, coded, scale,
                factor_mask=factor_mask) + log_prior_density(
        config, params, penalization_factor)


def exact_mll(config: SVGPConfig, params, X, Y, component_mask=None,
              coded=None, factor_mask=None, chol=_chol):
    """Exact Gaussian log marginal likelihood, via the Cholesky of
    K + σ²I: the objective of the M = N Gaussian fit. ``chol`` factors
    K + σ²I (the line search may pass ``linalg.cholesky_hybrid``)."""
    if config.likelihood.name != "gaussian":
        raise ValueError("exact_mll needs the Gaussian likelihood")
    N = X.shape[-2]
    noise = config.likelihood.constrain(params["lik_raw"])[..., 0]
    K = _K(config, params, X, X, component_mask, coded, factor_mask)
    Ky = K + noise[..., None, None] * _eye(N, K)
    L = chol(Ky)
    err = (Y - _mean(config, params, X))[..., 0]
    a = torch.cholesky_solve(err[..., None], L)[..., 0]
    return (-0.5 * torch.sum(err * a, dim=-1)
            - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
            - 0.5 * N * math.log(2.0 * math.pi))


def collapsed_elbo(config: SVGPConfig, params, X, Y, component_mask=None,
                   coded=None, factor_mask=None, chol=_chol):
    """The collapsed (Titsias) bound, max over q of the ELBO in closed form:
    log N(y; c, Qnn + σ²I) − tr(Knn − Qnn)/(2σ²) with Qnn = AᵀA, through
    B = I + AAᵀ/σ². The objective of the M < N Gaussian fit; ``chol``
    factors Kuu and B (the line search may pass
    ``linalg.cholesky_hybrid``)."""
    if config.likelihood.name != "gaussian":
        raise ValueError("collapsed_elbo needs the Gaussian likelihood")
    Z = params["z"]
    M, N = Z.shape[-2], X.shape[-2]
    noise = config.likelihood.constrain(params["lik_raw"])[..., 0]
    Kuu = _K(config, params, Z, Z, component_mask, coded, factor_mask)
    Kuu = Kuu + default_jitter(Kuu.dtype) * _eye(M, Kuu)
    L = chol(Kuu)
    Kuf = _K(config, params, Z, X, component_mask, coded, factor_mask)
    A = torch.linalg.solve_triangular(L, Kuf, upper=False)  # (..., M, N)

    err = (Y - _mean(config, params, X))[..., 0]
    B = _eye(M, A) + (A @ A.transpose(-1, -2)) / noise[..., None, None]
    LB = chol(B)
    # The quadratic form in residual form: errᵀ(Q + σ²I)⁻¹err = errᵀr/σ²
    # with r = err − AᵀB⁻¹A err/σ². The textbook −½‖err‖²/σ² + ½‖c‖²
    # cancels catastrophically in float32 as σ² nears its floor; here
    # every intermediate stays O(‖err‖²).
    Aerr = A @ err[..., None]
    w = torch.cholesky_solve(Aerr, LB) / noise[..., None, None]
    r = err - (A.transpose(-1, -2) @ w)[..., 0]
    quad = torch.sum(err * r, dim=-1) / noise

    Kdiag = _Kdiag(config, params, X, component_mask, coded, factor_mask)
    return (-0.5 * N * math.log(2.0 * math.pi)
            - torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)),
                        dim=-1)
            - 0.5 * N * torch.log(noise)
            - 0.5 * quad
            - 0.5 * (torch.sum(Kdiag, dim=-1)
                     - torch.sum(A * A, dim=(-2, -1))) / noise)


def optimal_q(config: SVGPConfig, params, X, Y, component_mask=None,
              coded=None, factor_mask=None):
    """Closed-form optimal whitened (q_mu, q_sqrt) for the Gaussian
    likelihood: Σ = (I + AAᵀ/σ²)⁻¹, q_mu = Σ A (y−c)/σ², q_sqrt = chol(Σ)."""
    Z = params["z"]
    M = Z.shape[-2]
    noise = config.likelihood.constrain(params["lik_raw"])[..., 0, None, None]
    Kuu = _K(config, params, Z, Z, component_mask, coded, factor_mask)
    Kuu = Kuu + default_jitter(Kuu.dtype) * _eye(M, Kuu)
    Kuf = _K(config, params, Z, X, component_mask, coded, factor_mask)
    L = _chol(Kuu)
    A = torch.linalg.solve_triangular(L, Kuf, upper=False)
    err = Y - _mean(config, params, X)
    eye = _eye(M, A)
    LB = _chol(eye + (A @ A.transpose(-1, -2)) / noise)
    Sigma = torch.cholesky_solve(eye.expand(LB.shape), LB)
    Sigma = 0.5 * (Sigma + Sigma.transpose(-1, -2))
    q_mu = Sigma @ (A @ err) / noise
    q_sqrt = _chol(Sigma + 1e-12 * eye)
    return q_mu, q_sqrt


def predict_f(config: SVGPConfig, params, Xnew, full_cov: bool = False,
              component_mask=None, coded=None, factor_mask=None):
    """Latent posterior at Xnew; Xnew is cast to the parameters' dtype."""
    Z = params["z"]
    Xnew = torch.as_tensor(Xnew, dtype=Z.dtype, device=Z.device)
    return _conditional(config, params, Xnew, component_mask, coded,
                        full_cov=full_cov, factor_mask=factor_mask)


def predict_y(config: SVGPConfig, params, Xnew, component_mask=None,
              coded=None, factor_mask=None):
    """Observation-space posterior moments, each (..., N, 1)."""
    fmean, fvar = predict_f(config, params, Xnew,
                            component_mask=component_mask, coded=coded,
                            factor_mask=factor_mask)
    lik_p = config.likelihood.constrain(params["lik_raw"])
    ymu, yvar = config.likelihood.predict_mean_and_var(
        lik_p, fmean[..., 0], fvar[..., 0])
    return ymu[..., None], yvar[..., None]


def predict_log_density(config: SVGPConfig, params, Xnew, Ynew,
                        component_mask=None, coded=None, factor_mask=None):
    fmean, fvar = predict_f(config, params, Xnew,
                            component_mask=component_mask, coded=coded,
                            factor_mask=factor_mask)
    lik_p = config.likelihood.constrain(params["lik_raw"])
    Ynew = torch.as_tensor(Ynew, dtype=fmean.dtype, device=fmean.device)
    return config.likelihood.predict_log_density(
        lik_p, fmean[..., 0], fvar[..., 0], Ynew[..., 0])

