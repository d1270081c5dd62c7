"""The M < N Gaussian path of the port against waveome_tpu's: the collapsed
(Titsias) bound, its gradients including ∂/∂Z, optimal q and predictions
with fewer inducing points than data, the GPflow golden of the bound, and
the segmented fit at M < N from the same start parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_svgp import GOLD, GOLD_RTOL, golden  # noqa: F401
from torch_parity import assert_close, t64, torch_spec

import bench
from waveome_tpu.fit.batch import _segmented_gaussian_fit as jseg_fit
from waveome_tpu.kernels import full_kernel_build
from waveome_tpu.models import svgp as jsvgp
from waveome_tpu_torch.fit import (
    auto_penalization_factor,
    penalized_finalize,
)
from waveome_tpu_torch.fit.batch import _segmented_gaussian_fit
from waveome_tpu_torch.fit.penalized import with_optimal_q
from waveome_tpu_torch.models import svgp

N, M = 40, 12
# float64 on both sides; the bound's terms are O(N) and its gradients come
# through the same Cholesky solves, so they agree to rounding (RTOL 1e-10);
# ATOL covers entries that are exactly 0 on one side and ~1e-16 on the other
ATOL = 1e-12


def _problem(B=2, seed=0):
    """The saturated kernel on a bench-shaped design (N = 40), B random
    parameter sets with M = 12 inducing points: rows of X with their time
    column shifted, so Z sits between the data."""
    rng = np.random.default_rng(seed)
    X, _ = bench.simulate(n_units=8, n_per=5, n_outcomes=1, seed=seed)
    jspec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                              return_sum=True)
    jconfig = jsvgp.make_config(jspec, "gaussian", num_data=N, input_dim=3,
                                num_inducing_points=M)
    config = svgp.make_config(torch_spec(jspec), "gaussian", num_data=N,
                              input_dim=3, num_inducing_points=M)
    sp = jspec.padded()
    z = np.stack([X[rng.choice(N, M, replace=False)] for _ in range(B)])
    z[..., 1] += 0.3 * rng.normal(size=(B, M))
    p = {
        "kernel_raw": 0.5 * rng.normal(size=(B, sp.num_components,
                                             sp.max_factors, 4)),
        "mean_c": rng.normal(size=(B, 1)),
        "lik_raw": rng.normal(size=(B, 1)) - 1.0,
        "q_mu": rng.normal(size=(B, M, 1)),
        "q_sqrt_raw": np.broadcast_to(np.eye(M), (B, M, M)).copy(),
        "z": z,
    }
    Ys = rng.normal(size=(B, N, 1))
    return jspec, jconfig, config, p, X, Ys


def _row(p, b):
    return {k: jnp.asarray(v[b]) for k, v in p.items()}


def _masks(jspec, which, B=2, seed=1):
    rng = np.random.default_rng(seed)
    sp = jspec.padded()
    C, F = sp.num_components, sp.max_factors
    cm = (rng.uniform(0.3, 1.0, (B, C)) if "c" in which else None)
    fm = ((rng.uniform(size=(B, C, F)) > 0.3).astype(float)
          if "f" in which else None)
    return cm, fm


@pytest.mark.parametrize("which", ["", "c", "f", "cf"])
def test_collapsed_elbo_matches_reference(which):
    jspec, jconfig, config, p, X, Ys = _problem()
    cm, fm = _masks(jspec, which)
    got = svgp.collapsed_elbo(config, svgp.params_from_jax(
        p, dtype=torch.float64), t64(X), t64(Ys),
        component_mask=None if cm is None else t64(cm),
        factor_mask=None if fm is None else t64(fm))
    for b in range(2):
        want = jsvgp.collapsed_elbo(
            jconfig, _row(p, b), jnp.asarray(X), jnp.asarray(Ys[b]),
            component_mask=None if cm is None else jnp.asarray(cm[b]),
            factor_mask=None if fm is None else jnp.asarray(fm[b]))
        assert_close(got[b], want)


def test_collapsed_bound_golden(golden):  # noqa: F811
    """tests/goldens: GPflow's SGPR bound at 8 inducing points, at the
    goldens' own tolerance."""
    spec, params, X, y = golden
    config = svgp.make_config(spec, "gaussian", num_data=X.shape[0],
                              input_dim=3, num_inducing_points=8)
    got = float(svgp.collapsed_elbo(config, params, X, y))
    np.testing.assert_allclose(got, GOLD["collapsed_bound"], rtol=GOLD_RTOL)


def test_collapsed_elbo_gradients_match_jax_grad():
    """∂bound/∂(kernel_raw, lik_raw, mean_c, z) through GramFn's analytic
    backward (raw and X cotangents) and the Murray Cholesky pullback,
    against jax.grad of the reference's bound."""
    _, jconfig, config, p, X, Ys = _problem()
    keys = ("kernel_raw", "lik_raw", "mean_c", "z")
    tp = svgp.params_from_jax(p, dtype=torch.float64)
    for k in keys:
        tp[k].requires_grad_(True)
    svgp.collapsed_elbo(config, tp, t64(X), t64(Ys)).sum().backward()
    for b in range(2):
        want = jax.grad(lambda q: jsvgp.collapsed_elbo(
            jconfig, q, jnp.asarray(X), jnp.asarray(Ys[b])))(_row(p, b))
        for k in keys:
            assert_close(tp[k].grad[b], want[k], atol=ATOL)
    # the categorical columns of Z do not move the bound
    assert torch.equal(tp["z"].grad[..., 0], torch.zeros(2, M,
                                                         dtype=torch.float64))


def test_optimal_q_and_predictions_at_fewer_inducing_points():
    _, jconfig, config, p, X, Ys = _problem()
    tp = svgp.params_from_jax(p, dtype=torch.float64)
    q_mu, q_sqrt = svgp.optimal_q(config, tp, t64(X), t64(Ys))
    tq = dict(tp, q_mu=q_mu, q_sqrt_raw=q_sqrt)
    Xnew = X[::3] + 0.1
    fmu, fvar = svgp.predict_f(config, tq, t64(Xnew))
    ymu, yvar = svgp.predict_y(config, tq, t64(Xnew))
    for b in range(2):
        jq_mu, jq_sqrt = jsvgp.optimal_q(jconfig, _row(p, b), jnp.asarray(X),
                                         jnp.asarray(Ys[b]))
        assert_close(q_mu[b], jq_mu, atol=ATOL)
        assert_close(q_sqrt[b], jq_sqrt, atol=ATOL)
        jp = dict(_row(p, b), q_mu=jq_mu, q_sqrt_raw=jq_sqrt)
        jfm, jfv = jsvgp.predict_f(jconfig, jp, jnp.asarray(Xnew))
        jym, jyv = jsvgp.predict_y(jconfig, jp, jnp.asarray(Xnew))
        assert_close(fmu[b], jfm, atol=ATOL)
        assert_close(fvar[b], jfv, atol=ATOL)
        assert_close(ymu[b], jym, atol=ATOL)
        assert_close(yvar[b], jyv, atol=ATOL)


def test_segmented_fit_at_fewer_inducing_points_matches_reference():
    """The M < N segmented branch (collapsed bound, Z trained) from the
    reference's own start parameters (its Z is drawn by jax.random and
    carried over): the same losses, masks and importances.

    Every row here converges within 46 iterations.
    A row that does not converge cannot be compared this way: Z's flat
    directions amplify the float64 rounding differences between the two
    implementations (~1e-10 in the gradient through a Kuu of large
    condition number) from iteration to iteration, so long unconverged
    trajectories part (bench seed 2, or M = 16, after ~10 iterations)."""
    X, Ys = bench.simulate(n_units=8, n_per=5, n_outcomes=4, seed=0)
    jspec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                              return_sum=True)
    jconfig = jsvgp.make_config(jspec, "gaussian", num_data=N, input_dim=3,
                                num_inducing_points=M)
    p0 = {k: np.asarray(v) for k, v in jsvgp.init_params(
        jconfig, jnp.asarray(X), key=jax.random.PRNGKey(0),
        dtype=jnp.float64).items()}
    want = jseg_fit(jconfig, p0, X, Ys, penalization_factor=None,
                    max_iter=150, segment_iters=150, var_cutoff=0.1,
                    importance_type="log_bf", compute_importances=True,
                    dtype=jnp.float64, seed=0)

    config = svgp.make_config(torch_spec(jspec), "gaussian", num_data=N,
                              input_dim=3, num_inducing_points=M)
    B = Ys.shape[1]
    tp0 = {k: v.expand((B,) + v.shape) for k, v in svgp.params_from_jax(
        p0, dtype=torch.float64).items()}
    Xt, Yt = t64(X), t64(Ys.T[:, :, None])
    factors = auto_penalization_factor(
        1.0, N, config.spec.num_variance_prior_params()).expand(B)
    params, loss, num_iters = _segmented_gaussian_fit(config, tp0, Xt, Yt,
                                                      factors, max_iter=150)
    params = with_optimal_q(config, params, Xt, Yt, chunk=B)
    cm, fm, imp = penalized_finalize(config, params, Xt, Yt)
    # a row may stop by the stall rule at the float64 rounding floor
    # (at most `patience` = 8 iterations apart); the losses agree anyway
    np.testing.assert_allclose(num_iters.numpy(),
                               np.asarray(want.num_iters), atol=8)
    assert_close(loss, want.loss)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(want.component_mask))
    np.testing.assert_array_equal(fm.numpy(), np.asarray(want.factor_mask))
    assert_close(imp, want.importances, atol=1e-12)
