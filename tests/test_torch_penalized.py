"""The slice as a whole: the port's fit_outcomes_penalized against
waveome_tpu's on bench-shaped simulated data (small N and B), with a fixed
factor, the σ̂ = 1 automatic factor and the iterated automatic factor,
plus its pruning, importances, penalization factor, data simulator,
default device, the hybrid trial Cholesky on the CPU and the branches it
refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch
from torch_parity import assert_close, t64, torch_spec

import bench
from waveome_tpu.fit import fit_outcomes_penalized as jfit
from waveome_tpu.fit import prune_masks as jprune_masks
from waveome_tpu.fit.penalized import (
    auto_penalization_factor as jauto_factor,
)
from waveome_tpu.fit.penalized import penalized_fit as jpenalized_fit
from waveome_tpu.interpret.importance import (
    feature_importance as jfeature_importance,
)
from waveome_tpu.kernels import full_kernel_build
from waveome_tpu.models import svgp as jsvgp
from waveome_tpu_torch import datasets
from waveome_tpu_torch.cuda_ops import diag_factor_cuda
from waveome_tpu_torch.fit import (
    auto_penalization_factor,
    fit_outcomes_penalized,
    prune_masks,
)
from waveome_tpu_torch.fit.batch import _segmented_gaussian_fit
from waveome_tpu_torch.fit.penalized import penalized_fit
from waveome_tpu_torch.interpret import feature_importance
from waveome_tpu_torch.models import svgp


@pytest.fixture(scope="module")
def data():
    X, Ys = bench.simulate(n_units=8, n_per=5, n_outcomes=4, seed=0)
    jspec, names = full_kernel_build(cat_vars=[0, 2], num_vars=[1],
                                     unit_idx=0,
                                     var_names=["id", "time", "female"],
                                     return_sum=True)
    return X, Ys, jspec


@pytest.mark.parametrize("factor,importance_type",
                         [(None, "log_bf"), (4.0, "statistic")])
def test_fit_outcomes_penalized_matches_reference(data, factor,
                                                  importance_type):
    """N = 40, 4 outcomes, float64: the same losses, masks and
    importances as the reference's segmented branch."""
    X, Ys, jspec = data
    kw = dict(num_inducing_points=X.shape[0], num_factor_iter=0,
              max_iter=60, penalization_factor=factor,
              importance_type=importance_type)
    want = jfit(X, Ys, spec=jspec, use_mesh=False, **kw).results
    res = fit_outcomes_penalized(X, Ys, spec=torch_spec(jspec),
                                 dtype=torch.float64, device="cpu", **kw)
    got = res.results
    assert res.num_outcomes == 4
    # The segmented branch stops at a gradient norm of 1e-8, below the
    # float64 rounding floor of these losses: there a trial's acceptance
    # is decided by rounding, and a row may stop by the stall rule (at most
    # `patience` = 8 iterations later) instead. The losses agree regardless.
    np.testing.assert_allclose(got.num_iters.numpy(),
                               np.asarray(want.num_iters), atol=8)
    assert_close(got.loss, want.loss)
    assert_close(got.penalization_factor, want.penalization_factor)
    np.testing.assert_array_equal(got.component_mask.numpy(),
                                  np.asarray(want.component_mask))
    np.testing.assert_array_equal(got.factor_mask.numpy(),
                                  np.asarray(want.factor_mask))
    # importances are rounded to 0.1 (log_bf, statistic) and 0.001
    # (residual); the scores agree to ~1e-9, far from a rounding edge
    assert_close(got.importances, want.importances, atol=1e-12)
    # fitted parameters: flat directions of the penalized objective leave
    # them less determined than the loss (see test_torch_plbfgs)
    assert_close(got.params["kernel_raw"], want.params["kernel_raw"],
                 rtol=1e-5, atol=1e-5)
    one = res.for_outcome(2)
    assert one.importances.shape == (jspec.num_components + 1,)
    assert float(one.loss) == float(got.loss[2])


def _fitted_like(jspec, X, B=3, seed=0):
    rng = np.random.default_rng(seed)
    N = X.shape[0]
    jconfig = jsvgp.make_config(jspec, "gaussian", num_data=N, input_dim=3,
                                num_inducing_points=N)
    sp = jspec.padded()
    p = {
        "kernel_raw": rng.normal(size=(B, sp.num_components,
                                       sp.max_factors, 4)),
        "mean_c": rng.normal(size=(B, 1)),
        "lik_raw": rng.normal(size=(B, 1)) - 2.0,
        "q_mu": rng.normal(size=(B, N, 1)),
        "q_sqrt_raw": np.broadcast_to(np.eye(N), (B, N, N)).copy(),
        "z": np.broadcast_to(X, (B, N, 3)).copy(),
    }
    return jconfig, p


def test_prune_masks_and_importances_match_reference(data):
    X, Ys, jspec = data
    jconfig, p = _fitted_like(jspec, X)
    config = svgp.make_config(torch_spec(jspec), "gaussian",
                              num_data=X.shape[0], input_dim=3,
                              num_inducing_points=X.shape[0])
    tp = svgp.params_from_jax(p, dtype=torch.float64)
    Y = Ys.T[:3, :, None]
    cm, fm = prune_masks(config, tp, t64(X), var_cutoff=0.5)
    for value in ("log_bf", "statistic", "deviance"):
        imp = feature_importance(config, tp, t64(X), t64(Y), cm, fm,
                                 return_value=value)
        for b in range(3):
            jp = {k: jnp.asarray(v[b]) for k, v in p.items()}
            jcm, jfm = jprune_masks(jconfig, jp, jnp.asarray(X), 0.5)
            np.testing.assert_array_equal(cm[b].numpy(), np.asarray(jcm))
            np.testing.assert_array_equal(fm[b].numpy(), np.asarray(jfm))
            want = jfeature_importance(jconfig, jp, jnp.asarray(X),
                                       jnp.asarray(Y[b]), jcm, jfm,
                                       return_value=value)
            assert_close(imp[b], want, atol=1e-12)


def test_auto_penalization_factor():
    got = float(auto_penalization_factor(1.3, 96, 4))
    want = 2 * 1.1 * 1.3 * np.sqrt(96) * st.norm().ppf(1 - 0.1 / 8)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, float(jauto_factor(1.3, 96, 4)),
                               rtol=1e-12)


@pytest.mark.parametrize("factor", [None, 9.0])
def test_factor_iteration_matches_reference(data, factor):
    """The users' default num_factor_iter = 5 at M = N (N = 40, so Z is the
    data on both sides), against the reference's vmapped penalized_fit:
    with the automatic factor (σ̂ = std(y), refits while the re-estimated
    factor falls by more than 1e-3) and with a fixed one (a single fit at
    penalized_fit's float64 ftol of 1e-9). The same iteration counts of the
    first fit, factors, losses, masks and importances."""
    X, Ys, jspec = data
    kw = dict(num_inducing_points=X.shape[0], num_factor_iter=5, max_iter=60,
              penalization_factor=factor)
    want = jfit(X, Ys, spec=jspec, use_mesh=False, **kw).results
    got = fit_outcomes_penalized(X, Ys, spec=torch_spec(jspec),
                                 dtype=torch.float64, device="cpu",
                                 **kw).results
    # a row at the float64 rounding floor may stop by the stall rule up to
    # `patience` = 8 iterations apart (equal counts were measured here)
    np.testing.assert_allclose(got.num_iters.numpy(),
                               np.asarray(want.num_iters), atol=8)
    # A single fit agrees to ~1e-15. A refit starts from the previous fit's
    # parameters, which the two sides determine only to ~1e-6 along the
    # objective's flat directions (test_fit_outcomes_penalized_matches_
    # reference holds them to 1e-5), with a factor re-estimated from them:
    # refitted losses and factors agree to ~1e-8 (7e-9 and 1e-8 here).
    # From the same first-fit parameters the refit agrees to 1e-10
    # (test_factor_refit_matches_reference_from_its_first_fit), so the gap
    # is the first fit's, not the refit's.
    rtol = 1e-10 if factor is not None else 1e-7
    assert_close(got.penalization_factor, want.penalization_factor,
                 rtol=rtol)
    assert_close(got.loss, want.loss, rtol=rtol)
    np.testing.assert_array_equal(got.component_mask.numpy(),
                                  np.asarray(want.component_mask))
    np.testing.assert_array_equal(got.factor_mask.numpy(),
                                  np.asarray(want.factor_mask))
    assert_close(got.importances, want.importances, atol=1e-12)
    if factor is None:
        # every outcome re-estimated its factor at least once, downwards
        # from its σ̂ = std(y) start
        assert bool((got.factor_rounds >= 1).all())
        start = auto_penalization_factor(torch.tensor(Ys).std(0),
                                         X.shape[0],
                                         jspec.num_variance_prior_params())
        assert bool((got.penalization_factor < start).all())
    else:
        assert bool((got.factor_rounds == 0).all())


def test_factor_refit_matches_reference_from_its_first_fit(data):
    """One factor round of the port's penalized_fit, started from the
    reference's own first fit (parameters, loss and iterations carried
    over), against the reference's refit of those parameters at its own
    re-estimated factor (penalized_fit with that factor, ftol 1e-9, as its
    factor loop calls it): the re-estimated factor, the stop test, the
    refit's start state, tolerances and loss agree to 1e-10."""
    X, Ys, jspec = data
    N, B = Ys.shape
    max_iter = 60
    jconfig = jsvgp.make_config(jspec, "gaussian", num_data=N, input_dim=3,
                                num_inducing_points=N)
    num_var = jspec.num_variance_prior_params()
    Xj, Yj = jnp.asarray(X), jnp.asarray(Ys.T)

    @jax.jit
    @jax.vmap
    def jfit_at(p, y, factor):
        r = jpenalized_fit(jconfig, p, Xj, y[:, None],
                           penalization_factor=factor, num_factor_iter=0,
                           max_iter=max_iter, stage="fit")
        return r.params, r.loss, r.num_iters

    p0 = jsvgp.init_params(jconfig, Xj, key=jax.random.PRNGKey(0),
                           dtype=jnp.float64)
    factor0 = jauto_factor(jnp.std(Yj, axis=1, ddof=1), N, num_var)
    first, first_loss, first_iters = jfit_at(
        jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p0),
        Yj, factor0)
    _, yvar = jax.vmap(lambda p: jsvgp.predict_y(jconfig, p, Xj))(first)
    nf = jauto_factor(jnp.sqrt(jnp.mean(yvar, axis=(1, 2))), N, num_var)
    assert not bool(((jnp.abs(nf - factor0) <= 1e-3) | (nf > factor0)).any())
    _, want_loss, _ = jfit_at(first, Yj, nf)

    config = svgp.make_config(torch_spec(jspec), "gaussian", num_data=N,
                              input_dim=3, num_inducing_points=N)
    Xt, Yt = t64(X), t64(Ys.T[:, :, None])
    first_t = svgp.params_from_jax(jax.tree.map(np.asarray, first),
                                   dtype=torch.float64)
    fits = []

    def fit(p, ys, fac):  # fit_outcomes_penalized's closure at float64
        fits.append(fac)
        if len(fits) == 1:  # the first fit: the reference's
            return ({k: v.clone() for k, v in first_t.items()},
                    t64(first_loss), torch.tensor(np.array(first_iters)))
        return _segmented_gaussian_fit(config, p, Xt, ys, fac, max_iter,
                                       ftol=1e-9)

    _, factor, loss, num_iters, rounds = penalized_fit(
        config, first_t, Xt, Yt, t64(factor0), fit, num_factor_iter=1,
        chunk=B)
    assert len(fits) == 2 and bool((rounds == 1).all())
    assert_close(fits[1], nf)
    assert_close(factor, nf)
    assert_close(loss, want_loss)
    np.testing.assert_array_equal(num_iters.numpy(), np.asarray(first_iters))


@pytest.mark.parametrize("shape", [(8, 5, 4, 0), (13, 3, 7, 11)])
def test_simulate_is_the_reference_data(shape):
    n_units, n_per, n_outcomes, seed = shape
    X, Ys = datasets.simulate(n_units, n_per, n_outcomes, seed)
    X_ref, Ys_ref = bench.simulate(n_units, n_per, n_outcomes, seed)
    np.testing.assert_array_equal(X, X_ref)
    np.testing.assert_array_equal(Ys, Ys_ref)


def test_fit_needs_a_device_without_cuda(data):
    """With no device given the fit runs on CUDA, and without CUDA it
    raises instead of falling back to the CPU (on a GPU machine the
    cuda-marked tests check the first half)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, Ys, jspec = data
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_outcomes_penalized(X, Ys[:, :1], spec=torch_spec(jspec),
                               max_iter=2)


def test_hybrid_trial_cholesky_runs_on_the_cpu():
    """The opt-in at M = 50 ≥ one 48-block: the trials' factorizations go
    through cholesky_hybrid with the plain diagonal-block factor (no kernel
    launch on CPU tensors); the gradients keep the default Cholesky."""
    X, Ys = datasets.simulate(n_units=10, n_per=5, n_outcomes=2)
    spec = torch_spec(full_kernel_build(cat_vars=[0, 2], num_vars=[1],
                                        unit_idx=0, return_sum=True))
    kw = dict(spec=spec, num_inducing_points=50, num_factor_iter=0,
              max_iter=20, dtype=torch.float64, device="cpu")
    before = diag_factor_cuda.launch_count
    on = fit_outcomes_penalized(X, Ys, hybrid_trial_cholesky=True,
                                **kw).results
    off = fit_outcomes_penalized(X, Ys, **kw).results
    assert diag_factor_cuda.launch_count == before
    # in float64 the hybrid's trial values equal the default's to ~1e-13,
    # so both line searches take the same steps (equal counts measured;
    # a tie at the rounding floor may move a stall stop by `patience`)
    assert_close(on.loss, off.loss, rtol=1e-8)
    np.testing.assert_allclose(on.num_iters.numpy(), off.num_iters.numpy(),
                               atol=8)


@pytest.mark.parametrize("kw", [
    dict(likelihood="poisson"),
    dict(num_restart=2, num_factor_iter=0),
    dict(batch_size=8, num_factor_iter=0),
    dict(objective="iterative", num_factor_iter=0),
    dict(use_mesh=True, num_factor_iter=0),
])
def test_unported_branches_raise(data, kw):
    X, Ys, jspec = data
    kw = {"num_factor_iter": 0, "num_inducing_points": 500, **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit_outcomes_penalized(X, Ys[:, :2], spec=torch_spec(jspec),
                               max_iter=2, dtype=torch.float64, device="cpu",
                               **kw)
