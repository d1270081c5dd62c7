"""The port's gram (gram_plain, the CPU path and K1's reference) and
GramFn's analytic backward (raw, mask and design cotangents) against
waveome_tpu's gram_xla, the Pallas kernel (interpret mode),
gram_vjp_analytic and jax.vjp; and the gram-in-a-loop harness of
tools/pallas_nan_min.py on the port's gram."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, t64, torch_spec

from waveome_tpu.bijectors import softplus_inv as jsoftplus_inv
from waveome_tpu.kernels.build import full_kernel_build as jfull_kernel_build
from waveome_tpu.kernels.gram import component_variances as jcomp_var
from waveome_tpu.kernels.gram import gram_diag as jgram_diag
from waveome_tpu.kernels.gram import gram_xla
from waveome_tpu.kernels.spec import KernelSpec as JSpec
from waveome_tpu.kernels.spec import Primitive as JPrim
from waveome_tpu.pallas_ops.gram_pallas import gram_pallas, gram_vjp_analytic
from waveome_tpu_torch.kernels.gram import (
    component_variances,
    gram,
    gram_diag,
    gram_plain,
)
from waveome_tpu_torch.tools import gram_nan_min

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "goldens",
                                   "gpflow_golden.json")))


def _saturated():
    spec, _ = jfull_kernel_build(
        cat_vars=[0, 2], num_vars=[1], unit_idx=0, var_names=["i", "t", "f"],
        return_sum=True,
        kerns=["squared_exponential", "matern12", "linear", "periodic"])
    return spec


def _mixed():
    """Every op, products, arccosine at each order, an empty component."""
    return JSpec((
        (JPrim("matern32", 0), JPrim("rational_quadratic", 1)),
        (JPrim("polynomial", 1),),
        (JPrim("matern52", 0), JPrim("constant", 0)),
        (JPrim("arccosine", 1, order=0),),
        (JPrim("arccosine", 0, order=2), JPrim("periodic", 1)),
        (JPrim("arccosine", 1),),
        (JPrim("categorical", 2), JPrim("squared_exponential", 1),
         JPrim("linear", 0)),
        (JPrim("empty"),),
    ))


def _data(seed, n1=20, n2=16):
    rng = np.random.default_rng(seed)

    def design(n):
        return np.column_stack([rng.integers(0, 5, n), rng.normal(size=n),
                                rng.integers(0, 2, n)]).astype(float)
    return rng, design(n1), design(n2)


def _masks(rng, spec, which):
    sp = spec.padded()
    C, F = sp.num_components, sp.max_factors
    cm = rng.uniform(0.2, 1.0, C) if "c" in which else None
    fm = (rng.uniform(size=(C, F)) > 0.3).astype(float) if "f" in which \
        else None
    return cm, fm


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else t64(a)


@pytest.mark.parametrize("which", ["", "c", "f", "cf"])
@pytest.mark.parametrize("make", [_saturated, _mixed])
def test_gram_plain_matches_gram_xla(make, which):
    jspec = make()
    rng, X1, X2 = _data(0)
    sp = jspec.padded()
    raw = 0.5 * rng.normal(size=(3, sp.num_components, sp.max_factors, 4))
    cm, fm = _masks(rng, jspec, which)
    got = gram_plain(torch_spec(jspec), t64(raw), t64(X1), t64(X2), _t(cm),
                     _t(fm))
    got_d = gram_diag(torch_spec(jspec), t64(raw), t64(X1), _t(cm), _t(fm))
    for b in range(3):
        want = gram_xla(jspec, jnp.asarray(raw[b]), jnp.asarray(X1),
                        jnp.asarray(X2), _j(cm), _j(fm))
        assert_close(got[b], want, atol=1e-13)
        want_d = jgram_diag(jspec, jnp.asarray(raw[b]), jnp.asarray(X1),
                            _j(cm), _j(fm))
        assert_close(got_d[b], want_d, atol=1e-13)


@pytest.mark.parametrize("with_mask", [False, True])
def test_gram_matches_pallas_kernel_interpret(with_mask):
    """The Pallas kernel in interpret mode, as tests/test_pallas_gram.py
    runs it (its op set has no arccosine)."""
    jspec = _saturated()
    rng, X1, X2 = _data(1, 40, 23)
    raw = np.asarray(jspec.init_raw_params_np()) + 0.1 * rng.normal(
        size=jspec.init_raw_params_np().shape)
    cm = rng.uniform(0.2, 1.0, jspec.num_components) if with_mask else None
    want = gram_pallas(jspec, jnp.asarray(raw), jnp.asarray(X1),
                       jnp.asarray(X2), _j(cm), interpret=True)
    got = gram(torch_spec(jspec), t64(raw), t64(X1), t64(X2), _t(cm))
    assert_close(got, want, atol=1e-13)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("make", [_saturated, _mixed])
def test_gramfn_backward_matches_analytic_vjp(make, with_mask):
    """GramFn's backward against gram_vjp_analytic (its op set) or, for
    specs with arccosine, jax.vjp of gram_xla; raw and mask cotangents."""
    jspec = make()
    rng, X1, X2 = _data(2)
    sp = jspec.padded()
    raw = rng.normal(size=(sp.num_components, sp.max_factors, 4))
    cot = rng.normal(size=(20, 16))
    cm = rng.uniform(0.2, 1.0, sp.num_components) if with_mask else None
    has_arccos = any(p.op == "arccosine" for c in jspec.components for p in c)
    if has_arccos:
        _, vjp = jax.vjp(lambda r, m: gram_xla(jspec, r, jnp.asarray(X1),
                                               jnp.asarray(X2), m),
                         jnp.asarray(raw), _j(cm))
        want_r, want_m = vjp(jnp.asarray(cot))
    else:
        want_r, want_m = gram_vjp_analytic(jspec, jnp.asarray(raw),
                                           jnp.asarray(X1), jnp.asarray(X2),
                                           _j(cm), jnp.asarray(cot))
    r = t64(raw).requires_grad_(True)
    m = None if cm is None else t64(cm).requires_grad_(True)
    (gram(torch_spec(jspec), r, t64(X1), t64(X2), m) * t64(cot)).sum() \
        .backward()
    assert_close(r.grad, want_r, atol=1e-12)
    if cm is not None:
        assert_close(m.grad, want_m, atol=1e-12)


def test_gramfn_backward_with_factor_mask_and_batch():
    """Factor-masked, batched (outcomes × trials) raw: against jax.vjp of
    gram_xla row by row."""
    jspec = _mixed()
    rng, X1, X2 = _data(3)
    sp = jspec.padded()
    C, F = sp.num_components, sp.max_factors
    raw = rng.normal(size=(2, 3, C, F, 4))
    fm = (rng.uniform(size=(3, C, F)) > 0.3).astype(float)
    cot = rng.normal(size=(2, 3, 20, 16))
    r = t64(raw).requires_grad_(True)
    (gram(torch_spec(jspec), r, t64(X1), t64(X2), None, t64(fm))
     * t64(cot)).sum().backward()
    for a in range(2):
        for b in range(3):
            _, vjp = jax.vjp(lambda q: gram_xla(jspec, q, jnp.asarray(X1),
                                                jnp.asarray(X2), None,
                                                jnp.asarray(fm[b])),
                             jnp.asarray(raw[a, b]))
            (want,) = vjp(jnp.asarray(cot[a, b]))
            assert_close(r.grad[a, b], want, atol=1e-12)


def test_gramfn_refuses_design_gradients():
    """GramFn refuses a factor_mask gradient, and the design gradient it
    now computes is the one of autograd through gram_plain."""
    spec = torch_spec(_saturated())
    sp = spec.padded()
    X = t64(_data(4)[1]).requires_grad_(True)
    raw = torch.zeros((sp.num_components, sp.max_factors, 4),
                      dtype=torch.float64)
    fm = torch.ones((sp.num_components, sp.max_factors), dtype=torch.float64,
                    requires_grad=True)
    with pytest.raises(ValueError, match="factor_mask"):
        gram(spec, raw, X, None, None, fm)
    gram(spec, raw, X).sum().backward()
    X2 = X.detach().clone().requires_grad_(True)
    gram_plain(spec, raw, X2).sum().backward()
    assert_close(X.grad, X2.grad, atol=1e-13)


@pytest.mark.parametrize("which", ["", "cf"])
@pytest.mark.parametrize("make", [_saturated, _mixed])
def test_gramfn_design_gradients_match_jax(make, which):
    """∂⟨cot, K⟩/∂X1 and /∂X2 of all 12 ops (the two specs hold them all)
    with component and factor masks, X1 batched over 3 parameter sets and
    X2 shared: against jax.vjp of gram_xla row by row and against autograd
    through gram_plain. Categorical columns get zero, as JAX's round."""
    jspec = make()
    rng, X1, X2 = _data(6)
    sp = jspec.padded()
    raw = 0.5 * rng.normal(size=(3, sp.num_components, sp.max_factors, 4))
    X1b = np.stack([X1 + 0.1 * b for b in range(3)])
    X1b[..., 1] += 0.2 * rng.normal(size=X1b.shape[:-1])
    cm, fm = _masks(rng, jspec, which)
    cot = rng.normal(size=(3, 20, 16))
    spec = torch_spec(jspec)
    a1, a2 = t64(X1b).requires_grad_(True), t64(X2).requires_grad_(True)
    (gram(spec, t64(raw), a1, a2, _t(cm), _t(fm)) * t64(cot)).sum() \
        .backward()
    b1, b2 = t64(X1b).requires_grad_(True), t64(X2).requires_grad_(True)
    (gram_plain(spec, t64(raw), b1, b2, _t(cm), _t(fm)) * t64(cot)).sum() \
        .backward()
    assert_close(a1.grad, b1.grad.numpy(), atol=1e-12)
    assert_close(a2.grad, b2.grad.numpy(), atol=1e-12)
    want2 = np.zeros_like(X2)
    for b in range(3):
        _, vjp = jax.vjp(lambda x1, x2: gram_xla(jspec, jnp.asarray(raw[b]),
                                                 x1, x2, _j(cm), _j(fm)),
                         jnp.asarray(X1b[b]), jnp.asarray(X2))
        w1, w2 = vjp(jnp.asarray(cot[b]))
        assert_close(a1.grad[b], w1, atol=1e-12)
        want2 += np.asarray(w2)
    assert_close(a2.grad, want2, atol=1e-12)


@pytest.mark.parametrize("D", [1, 2])
def test_gram_loop_harness_plain_path(D):
    """tools/gram_nan_min on the CPU: 4 problems, 8 one-coordinate steps
    through GramFn; every gradient finite, every problem runs all 8 steps,
    and the iterates follow the same loop through gram_plain to float32
    rounding of the analytic against the autograd backward (2.4e-6
    measured)."""
    its, bad, hist = gram_nan_min.run(D=D, device="cpu")
    its_p, bad_p, hist_p = gram_nan_min.run(D=D, plain=True, device="cpu")
    assert its.tolist() == [8] * 4 and not bool(bad.any())
    assert torch.equal(its, its_p) and not bool(bad_p.any())
    assert hist.shape == (9, 4, 3)
    assert float((hist - hist_p).abs().max()) < 1e-5
    # each step moved only its own coordinate
    moved = (hist[1:] != hist[:-1]).any(dim=1)
    assert torch.equal(moved, torch.eye(3, dtype=torch.bool)[
        torch.arange(8) % 3])


def test_gram_loop_harness_needs_a_device_without_cuda():
    """With no device given the harness runs on CUDA, and without CUDA it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gram_nan_min.run(D=1, steps=1)


def test_component_variances_match_reference():
    jspec = _mixed()
    sp = jspec.padded()
    raw = np.random.default_rng(5).normal(
        size=(2, sp.num_components, sp.max_factors, 4))
    got = component_variances(torch_spec(jspec), t64(raw))
    for b in range(2):
        assert_close(got[b], jcomp_var(jspec, jnp.asarray(raw[b])))


def test_gram_checksums_golden():
    """tests/goldens: an independent float64 implementation of GPflow's
    kernels, at the goldens' own tolerance of 1e-6."""
    th, d = GOLD["theta"], GOLD["data"]
    jspec = JSpec((
        (JPrim("categorical", 0),),
        (JPrim("squared_exponential", 1),),
        (JPrim("categorical", 2), JPrim("matern12", 1)),
        (JPrim("periodic", 1),),
    ))

    def spi(v):
        return float(jsoftplus_inv(jnp.asarray(v, dtype=jnp.float64)))
    raw = np.zeros((4, 2, 4))
    raw[0, 0, 0], raw[1, 0, 0], raw[1, 0, 1] = (spi(th["v0"]), spi(th["v1"]),
                                                spi(th["ls1"]))
    raw[2, 0, 0], raw[2, 1, 0], raw[2, 1, 1] = (spi(th["v2"]), spi(1.0),
                                                spi(th["ls2"]))
    raw[3, 0, 0], raw[3, 0, 1], raw[3, 0, 2] = (spi(th["v3"]),
                                                spi(th["ls3"]),
                                                spi(th["period"]))
    spec, X, Z = torch_spec(jspec), t64(d["X"]), t64(d["Z"])
    K = gram(spec, t64(raw), X)
    cs = GOLD["gram_checksums"]
    np.testing.assert_allclose(float(torch.trace(K)), cs["K_full_trace"],
                               rtol=1e-6)
    np.testing.assert_allclose(float(K.sum()), cs["K_full_sum"], rtol=1e-6)
    np.testing.assert_allclose(float(gram(spec, t64(raw), Z, X).sum()),
                               cs["Kuf_sum"], rtol=1e-6)
