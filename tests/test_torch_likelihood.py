"""The port's marginal likelihood (gpr_tpu_torch.gp.likelihood) and kernel
derivatives against gpr_tpu's, on the CPU in float64.

The same numpy inputs (seeded) go through both packages.  Values, gradients
and jacobians agree to 1e-9 relative (same factorization route, sums in
another order, and the gradient through another reverse pass: autograd
through the Murray pullback against jax.grad through the same pullback);
n = 64 takes the direct route and n = 1100 the blocked route in both.
Derivative stacks agree to 1e-12 (the same formulas elementwise).
"""

import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from gpr_tpu.gp import likelihood as jlk
from gpr_tpu.kernels import kernels as jkm
from gpr_tpu_torch.gp import likelihood as tlk
from gpr_tpu_torch.kernels import kernels as tkm

MLL_KERNELS = [
    "GaussianKernel(1.3,0.9,)",
    "GaussianExpKernel(0.2,-0.1,)",
    "RationalQuadraticKernel(1.2,2,3,)",
    "Matern52Kernel(2,1,)",
    "SumKernel(GaussianKernel(1.4,1.1,),PeriodicKernel(1.2,0.7,0.9,))",
    "SumKernel(GaussianKernel(1.5,1,),WhiteKernel(0.10000000000000001,))",
]

# every class, for the derivative forms
DERIV_KERNELS = MLL_KERNELS + [
    "WhiteKernel(1.7,)",
    "Matern12Kernel(1.3,0.90000000000000002,)",
    "Matern32Kernel(1.3,0.90000000000000002,)",
    "GaussianARDKernel(3,0.5,1.5,2.5,1.2,)",
    "LinearKernel(0.69999999999999996,0.29999999999999999,)",
    "ConstantKernel(0.40000000000000002,)",
    "ProductKernel(Matern52Kernel(1.3,0.9,),PeriodicKernel(1.5,0.8,1.1,))",
]

REL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _data(n, d=3, q=2, seed=15):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    Y = np.sin(X.sum(1, keepdims=True)) + 0.3 * rng.standard_normal((n, q))
    return X, Y


@pytest.mark.parametrize("n", [64, 1100])
@pytest.mark.parametrize("kstr", MLL_KERNELS)
def test_likelihood_functions_match_jax(kstr, n):
    X, Y = _data(n)
    jk, tk = jg.parse_kernel(kstr), tg.parse_kernel(kstr)
    sigma = 0.3
    args = (X, Y, sigma)
    for name in ("gaussian_log_likelihood", "mll_scalar"):
        assert _rel(getattr(tlk, name)(tk, *args, device="cpu"), getattr(jlk, name)(jk, *args)) < REL
    if n == 64:  # at n = 1100 the likelihood itself underflows to 0 in both
        assert _rel(tlk.gaussian_likelihood(tk, *args, device="cpu"),
                    jlk.gaussian_likelihood(jk, *args)) < REL
    vt, gt = tlk.mll_value_and_grad(tk, *args, device="cpu")
    vj, gj = jlk.mll_value_and_grad(jk, *args)
    assert gt.dtype == torch.float64 and gt.shape == (tk.num_params,)
    assert _rel(vt, vj) < REL and _rel(gt, gj) < REL
    vt, Jt = tlk.mll_jacobian(tk, *args, device="cpu")
    vj, Jj = jlk.mll_jacobian(jk, *args)
    assert Jt.shape == (Y.shape[1], tk.num_params)
    assert _rel(vt, vj) < REL and _rel(Jt, Jj) < REL
    # the gradient is the sum of the jacobian's rows less (q - 1) complexity
    # gradients; cheaper to check against the scalar objective by autograd
    vec = tkm.params_vector(tk).requires_grad_()
    (g,) = torch.autograd.grad(tlk.mll_scalar(tk.with_params(list(vec)), *args, device="cpu"), vec)
    assert _rel(g, gt) < 1e-12


def test_reference_trace_formula():
    """The gradient is the reference's 0.5 tr((alpha alpha^T - C) dK/dtheta_p)
    (Likelihood.h:224-228) with its hand-derived dK/dtheta
    (cf. tests/test_likelihood_priors.py:59-77)."""
    X, Y = _data(10, d=2, seed=16)
    tk = tg.parse_kernel(MLL_KERNELS[4])
    sigma = 0.4
    _, grad = tlk.mll_value_and_grad(tk, X, Y, sigma, device="cpu")
    K = tg.gram(tk, torch.tensor(X)).numpy() + sigma**2 * np.eye(10)
    C = np.linalg.inv(K)
    alpha = C @ Y
    D = tkm.analytic_gram_derivative(tk, torch.tensor(X)).numpy()
    ref = [0.5 * np.trace((alpha @ alpha.T - C) @ D[p]) for p in range(D.shape[0])]
    np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-7, atol=1e-9)
    _, J = tlk.mll_jacobian(tk, X, Y, sigma, device="cpu")
    for i in range(2):
        a = C @ Y[:, i:i + 1]
        ref = [0.5 * np.trace((a @ a.T - C) @ D[p]) for p in range(D.shape[0])]
        np.testing.assert_allclose(J[i].numpy(), ref, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("kstr", DERIV_KERNELS)
def test_derivatives_match_jax(kstr):
    rng = np.random.default_rng(17)
    X = rng.standard_normal((9, 3))
    Y = rng.standard_normal((7, 3))
    X[4] = X[1]  # a repeated row for White
    jk, tk = jg.parse_kernel(kstr), tg.parse_kernel(kstr)
    np.testing.assert_array_equal(tkm.params_vector(tk).numpy(), np.asarray(jkm.params_vector(jk)))
    D = tg.gram_derivative(tk, torch.tensor(X))
    assert D.shape == (tk.num_params, 9, 9)
    np.testing.assert_allclose(D.numpy(), np.asarray(jkm.gram_derivative(jk, X)),
                               rtol=1e-12, atol=1e-12)
    for args in ((X,), (X, Y)):
        At = tkm.analytic_gram_derivative(tk, *[torch.tensor(a) for a in args]).numpy()
        np.testing.assert_allclose(At, np.asarray(jkm.analytic_gram_derivative(jk, *args)),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tk.analytic_derivative(torch.tensor(X[0]), torch.tensor(Y[2])).numpy(),
                               np.asarray(jk.analytic_derivative(X[0], Y[2])), rtol=1e-12,
                               atol=1e-12)


def test_float32_gram_under_float64_hyperparameters_stays_float32():
    X = torch.tensor(np.random.default_rng(18).standard_normal((50, 3)), dtype=torch.float32)
    for kstr in DERIV_KERNELS:
        tk = tg.parse_kernel(kstr)
        vec = tkm.params_vector(tk).requires_grad_()
        K = tg.gram(tk.with_params(list(vec)), X)
        assert K.dtype == torch.float32, kstr
        (g,) = torch.autograd.grad(K.sum(), vec)
        assert g.dtype == torch.float64 and torch.isfinite(g).all(), kstr


def test_gradient_is_zero_when_no_jitter_factors():
    # Linear with a large negative offset: K has an eigenvalue of about
    # -100 n, far past the largest jitter (eps * 10^6 * mean|diag|)
    X, Y = _data(12)
    kstr = "LinearKernel(1,-100,)"
    vt, gt = tlk.mll_value_and_grad(tg.parse_kernel(kstr), X, Y, 0.1, device="cpu")
    vj, gj = jlk.mll_value_and_grad(jg.parse_kernel(kstr), X, Y, 0.1)
    assert not torch.isfinite(vt).any() and not np.isfinite(np.asarray(vj)).any()
    assert torch.equal(gt, torch.zeros_like(gt))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    _, J = tlk.mll_jacobian(tg.parse_kernel(kstr), X, Y, 0.1, device="cpu")
    assert torch.equal(J, torch.zeros_like(J))


def test_numpy_input_without_a_device_raises_here():
    # the entry points run on the card unless told otherwise; this machine
    # has none (the marker-free tests run where torch.cuda is unavailable)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, Y = _data(8)
    k = tg.Gaussian(1.0)
    for call in (lambda: tlk.mll_value_and_grad(k, X, Y, 0.1),
                 lambda: tlk.mll_scalar(k, X, Y, 0.1),
                 lambda: tg.fit_mle(k, X, Y, 0.1, iterations=1),
                 lambda: tg.fit(k, X, Y, 0.1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # CPU tensors, or device="cpu", run here
    tlk.mll_scalar(k, torch.tensor(X), torch.tensor(Y), 0.1)
    tlk.mll_scalar(k, X, Y, 0.1, device="cpu")
