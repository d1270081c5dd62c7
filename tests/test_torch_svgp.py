"""The port's models/svgp.py against waveome_tpu's: the exact Gaussian MLL,
the horseshoe prior density, optimal q, predictions, the driver's entry()
forward step, and the GPflow goldens the slice covers."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, t64, torch_spec

import __graft_entry__ as graft
from waveome_tpu.bijectors import softplus_inv as jsoftplus_inv
from waveome_tpu.kernels.spec import KernelSpec as JSpec
from waveome_tpu.kernels.spec import Primitive as JPrim
from waveome_tpu.models import svgp as jsvgp
from waveome_tpu_torch.models import svgp

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "goldens",
                                   "gpflow_golden.json")))
GOLD_RTOL = 1e-6  # the goldens' own tolerance (independent implementation)


def _spi(v):
    return float(jsoftplus_inv(jnp.asarray(v, dtype=jnp.float64)))


@pytest.fixture(scope="module")
def golden():
    th, d = GOLD["theta"], GOLD["data"]
    jspec = JSpec((
        (JPrim("categorical", 0),),
        (JPrim("squared_exponential", 1),),
        (JPrim("categorical", 2), JPrim("matern12", 1)),
        (JPrim("periodic", 1),),
    ))
    raw = np.zeros((4, 2, 4))
    raw[0, 0, 0], raw[1, 0, 0], raw[1, 0, 1] = (_spi(th["v0"]),
                                                _spi(th["v1"]),
                                                _spi(th["ls1"]))
    raw[2, 0, 0], raw[2, 1, 0], raw[2, 1, 1] = (_spi(th["v2"]), _spi(1.0),
                                                _spi(th["ls2"]))
    raw[3, 0, 0], raw[3, 0, 1], raw[3, 0, 2] = (_spi(th["v3"]),
                                                _spi(th["ls3"]),
                                                _spi(th["period"]))
    noise = GOLD["lik_params"]["gaussian"]["variance"]
    params = svgp.params_from_jax({
        "kernel_raw": raw, "mean_c": [th["mean_c"]],
        "lik_raw": [_spi(noise - 1e-6)], "q_mu": d["q_mu"],
        "q_sqrt_raw": d["q_sqrt"], "z": d["Z"],
    }, dtype=torch.float64)
    X = t64(d["X"])
    y = t64(d["y_cont"])[:, None]
    return torch_spec(jspec), params, X, y


def test_exact_mll_golden(golden):
    spec, params, X, y = golden
    config = svgp.make_config(spec, "gaussian", num_data=X.shape[0],
                              input_dim=3, num_inducing_points=X.shape[0])
    got = float(svgp.exact_mll(config, params, X, y))
    np.testing.assert_allclose(got, GOLD["exact_gpr_mll"], rtol=GOLD_RTOL)


def test_kl_and_gaussian_elbo_and_log_density_golden(golden):
    spec, params, X, y = golden
    np.testing.assert_allclose(float(svgp.kl_whitened(params)),
                               GOLD["kl_whitened"], rtol=GOLD_RTOL)
    config = svgp.make_config(spec, "gaussian", num_data=X.shape[0],
                              input_dim=3, num_inducing_points=8)
    np.testing.assert_allclose(float(svgp.elbo(config, params, X, y)),
                               GOLD["svgp_elbo"]["gaussian"], rtol=GOLD_RTOL)
    ld = svgp.predict_log_density(config, params, X[5:15], y[5:15])
    np.testing.assert_allclose(ld.numpy(),
                               GOLD["predict_log_density"]["gaussian"],
                               rtol=GOLD_RTOL, atol=1e-9)


def _problem(B=3, N=24, M=None, seed=0):
    """A saturated-kernel problem with B random parameter sets: the JAX
    config, the port's, numpy params (leading axis B), X and Ys (B, N, 1)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.repeat(np.arange(6), N // 6),
                         np.tile(np.linspace(-2, 2, N // 6), 6),
                         np.repeat(np.arange(6) % 2, N // 6)]).astype(float)
    from waveome_tpu.kernels import full_kernel_build
    jspec = full_kernel_build(cat_vars=[0, 2], num_vars=[1], unit_idx=0,
                              return_sum=True)
    M = M or N
    jconfig = jsvgp.make_config(jspec, "gaussian", num_data=N, input_dim=3,
                                num_inducing_points=M)
    config = svgp.make_config(torch_spec(jspec), "gaussian", num_data=N,
                              input_dim=3, num_inducing_points=M)
    sp = jspec.padded()
    p = {
        "kernel_raw": 0.7 * rng.normal(size=(B, sp.num_components,
                                             sp.max_factors, 4)),
        "mean_c": rng.normal(size=(B, 1)),
        "lik_raw": rng.normal(size=(B, 1)) - 1.0,
        "q_mu": rng.normal(size=(B, M, 1)),
        "q_sqrt_raw": np.tril(0.3 * rng.normal(size=(B, M, M)))
        + np.eye(M),
        "z": np.broadcast_to(X[:M], (B, M, 3)).copy(),
    }
    Ys = rng.normal(size=(B, N, 1))
    return jconfig, config, p, X, Ys


def _row(p, b):
    return {k: jnp.asarray(v[b]) for k, v in p.items()}


def test_exact_mll_and_prior_match_reference():
    jconfig, config, p, X, Ys = _problem()
    tp = svgp.params_from_jax(p, dtype=torch.float64)
    factors = np.array([0.0, 2.5, 40.0])
    got = svgp.exact_mll(config, tp, t64(X), t64(Ys))
    got_lp = svgp.log_prior_density(config, tp, t64(factors))
    for b in range(3):
        assert_close(got[b], jsvgp.exact_mll(jconfig, _row(p, b),
                                             jnp.asarray(X),
                                             jnp.asarray(Ys[b])))
        assert_close(got_lp[b], jsvgp.log_prior_density(
            jconfig, _row(p, b), jnp.asarray(factors[b])))
    for off in (None, 0.0, -1.0):
        assert torch.equal(svgp.log_prior_density(config, tp, off),
                           torch.zeros(3, dtype=torch.float64))


def test_optimal_q_and_predictions_match_reference():
    jconfig, config, p, X, Ys = _problem(B=2, N=18)
    tp = svgp.params_from_jax(p, dtype=torch.float64)
    q_mu, q_sqrt = svgp.optimal_q(config, tp, t64(X), t64(Ys))
    Xnew = X[::2] + 0.1
    cm = np.array([[1.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 1.0]])
    ymu, yvar = svgp.predict_y(config, tp, t64(Xnew), component_mask=t64(cm))
    fmu, fcov = svgp.predict_f(config, tp, t64(Xnew), full_cov=True)
    for b in range(2):
        jq_mu, jq_sqrt = jsvgp.optimal_q(jconfig, _row(p, b), jnp.asarray(X),
                                         jnp.asarray(Ys[b]))
        assert_close(q_mu[b], jq_mu, rtol=1e-8, atol=1e-10)  # cond(Kuu)
        assert_close(q_sqrt[b], jq_sqrt, rtol=1e-8, atol=1e-10)
        jm, jv = jsvgp.predict_y(jconfig, _row(p, b), jnp.asarray(Xnew),
                                 component_mask=jnp.asarray(cm[b]))
        assert_close(ymu[b], jm, atol=1e-10)
        assert_close(yvar[b], jv, atol=1e-10)
        jfm, jfc = jsvgp.predict_f(jconfig, _row(p, b), jnp.asarray(Xnew),
                                   full_cov=True)
        assert_close(fmu[b], jfm, atol=1e-10)
        assert_close(fcov[b], jfc, atol=1e-10)


def test_entry_forward_step_matches_reference():
    """The counterpart of __graft_entry__.entry(): log_posterior with a
    penalty plus predict_f on the tutorial design (M = 32 < N = 64), on
    the reference's own parameters."""
    jconfig, jparams, X = graft._toy_problem(dtype=jnp.float64)
    Y = np.random.default_rng(1).normal(size=(X.shape[0], 1))
    want_lp = jsvgp.log_posterior(jconfig, jparams, X, jnp.asarray(Y),
                                  penalization_factor=10.0)
    want_mu, want_var = jsvgp.predict_f(jconfig, jparams, X)

    config = svgp.make_config(torch_spec(jconfig.spec), "gaussian",
                              num_data=X.shape[0], input_dim=3,
                              num_inducing_points=32)
    params = svgp.params_from_jax({k: np.asarray(v)
                                   for k, v in jparams.items()},
                                  dtype=torch.float64)
    lp = svgp.log_posterior(config, params, t64(X), t64(Y),
                            penalization_factor=10.0)
    mu, var = svgp.predict_f(config, params, t64(X))
    assert_close(lp, want_lp)
    assert_close(mu, want_mu, atol=1e-12)
    assert_close(var, want_var, atol=1e-12)


def test_init_params_and_masks():
    jconfig, config, _, X, _ = _problem(N=24)
    p = svgp.init_params(config, X, dtype=torch.float64)
    jp = jsvgp.init_params(jconfig, jnp.asarray(X), dtype=jnp.float64)
    for k in svgp.PARAM_KEYS:
        assert_close(p[k], jp[k])
    jm = jsvgp.train_mask_np(jconfig)
    for k, m in svgp.train_mask_np(config).items():
        np.testing.assert_array_equal(m, jm[k])
    small = svgp.make_config(config.spec, "gaussian", num_data=24,
                             input_dim=3, num_inducing_points=10)
    g = torch.Generator().manual_seed(3)
    ps = svgp.init_params(small, X, generator=g, dtype=torch.float64)
    z = ps["z"]
    assert z.shape == (10, 3)
    # M < N: distinct rows of X, the same ones for the same seed
    rows = [int(np.flatnonzero((X == r).all(1))[0]) for r in z.numpy()]
    assert len(set(rows)) == 10
    g = torch.Generator().manual_seed(3)
    assert torch.equal(svgp.init_params(small, X, generator=g,
                                        dtype=torch.float64)["z"], z)
    assert bool(torch.isfinite(svgp.collapsed_elbo(small, ps, t64(X),
                                                   t64(X[:, 1:2]))))
