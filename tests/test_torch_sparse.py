"""The port's sparse GP (gpr_tpu_torch.gp.sparse) and its sparse log
posterior (inference.hmc.make_sparse_gp_log_posterior) against gpr_tpu's, on
the CPU in float64.

Fits, predictions and covariances are held at rtol 1e-9.  The Woodbury
solve, the likelihood, its gradients, the Titsias bound and the log
posterior go through the inner matrix Kmm + s^-2 Kmn Knm, whose condition
number reaches 3e7 (the likelihood's data) and 2e8 (the log posterior's at
lengthscale e), inducing points lying 0.01 from data points: the two
packages factor it in other orders, so they agree to ~cond * eps, and are
held at RTOL_INNER = 1e-7.  The
Adam traces of ``optimize_inducing`` and ``fit_svgp`` over 10 steps are held
at 1e-8.  The log posterior of several chains is held to JAX's per-chain
``logp`` under ``jax.vmap`` on the fleet's routes (``torch-cholesky`` and,
with ``use_crout=True``, the plain K7 version), with one chain out of range
(NaN in both packages).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from gpr_tpu.gp import sparse as js
from gpr_tpu.inference import hmc as jh
from gpr_tpu.inference import priors as jp
from gpr_tpu_torch import convert
from gpr_tpu_torch.gp import sparse as ts
from gpr_tpu_torch.inference import hmc as th
from gpr_tpu_torch.inference import priors as tp
from gpr_tpu_torch.ops import _cuda

from test_torch_hmc import _one_torch_thread  # noqa: F401

RTOL = 1e-9
RTOL_INNER = 1e-7


def _close(a, b, rtol=RTOL):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _toy(n=48, m=10, d=2, q=2, seed=0):
    # tests/test_sparse_gp.py::_toy's recipe
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    Z = X[rng.choice(n, m, replace=False)] + 0.01 * rng.standard_normal((m, d))
    Y = np.stack([np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n) for _ in range(q)], axis=1)
    return X, Z, Y


KERNELS = {
    "gaussian": ("GaussianKernel(1.5, 1,)", lambda: jg.Gaussian(1.5, 1.0)),
    "sum_white": ("SumKernel(GaussianKernel(1.2, 0.9,),WhiteKernel(0.2,))",
                  lambda: jg.Sum(jg.Gaussian(1.2, 0.9), jg.White(0.2))),
    "matern52": ("Matern52Kernel(0.8, 1.1,)", lambda: jg.Matern52(0.8, 1.1)),
}


def _kernels(name):
    string, jax_kernel = KERNELS[name]
    return tg.parse_kernel(string), jax_kernel()


@pytest.mark.parametrize("name,jitter", [("gaussian", 0.0), ("sum_white", 1e-6), ("matern52", 1e-8)])
def test_fit_predict_and_covariance_match_jax(name, jitter):
    X, Z, Y = _toy()
    tk, jk = _kernels(name)
    js_ = js.fit_sparse(jk, Z, X, Y, 0.3, jitter)
    sgp = ts.fit_sparse(tk, Z, X, Y, 0.3, jitter, device="cpu")
    assert sgp.route == "torch-cholesky" and sgp.num_inducing == 10
    for key in ("alpha", "R", "Lmm"):
        _close(getattr(sgp, key), getattr(js_, key))
    Xs = np.random.default_rng(5).standard_normal((7, 2))
    _close(sgp.predict(Xs), js_.predict(Xs))
    _close(sgp.predict(Xs[3]), js_.predict(Xs[3]))
    _close(sgp.posterior_cov(Xs[0], Xs[1]), js_.posterior_cov(Xs[0], Xs[1]))
    _close(sgp.credible_interval(Xs[2]), js_.credible_interval(Xs[2]))
    assert isinstance(sgp, torch.nn.Module)
    assert {"Z", "X", "Y", "sigma", "jitter", "alpha", "R", "Lmm"} <= dict(sgp.named_buffers()).keys()


@pytest.mark.parametrize("name,jitter", [("gaussian", 1e-8), ("sum_white", 0.0)])
def test_woodbury_likelihood_gradients_and_elbo_match_jax(name, jitter):
    X, Z, Y = _toy(seed=1)
    tk, jk = _kernels(name)
    Zt, Xt, Yt = (torch.tensor(a) for a in (Z, X, Y))
    Lmm, Knm, Linner, s2, logdet, n, m = ts._woodbury_pieces(tk, Zt, Xt, 0.3, jitter)
    jLmm, jKnm, jLinner, js2, jlogdet, _, _ = js._woodbury_pieces(jk, Z, X, 0.3, jitter)
    _close(ts.woodbury_solve(Knm, Linner, s2, Yt),
           js.woodbury_solve(jKnm, jLinner, js2, jnp.asarray(Y)), RTOL_INNER)
    _close(logdet, jlogdet, RTOL_INNER)
    _close(ts.sparse_log_likelihood(tk, Z, X, Y, 0.3, jitter, device="cpu"),
           js.sparse_log_likelihood(jk, Z, X, Y, 0.3, jitter), RTOL_INNER)
    _close(ts.sparse_mll_scalar(tk, Z, X, Y, 0.3, jitter, device="cpu"),
           js.sparse_mll_scalar(jk, Z, X, Y, 0.3, jitter), RTOL_INNER)
    v, g = ts.sparse_mll_value_and_grad(tk, Z, X, Y, 0.3, jitter, device="cpu")
    jv, jgr = js.sparse_mll_value_and_grad(jk, Z, X, Y, 0.3, jitter)
    _close(v, jv, RTOL_INNER)
    _close(g, jgr, RTOL_INNER)
    vi, gi = ts.sparse_mll_and_grad_inducing(tk, Z, X, Y, 0.3, jitter, device="cpu")
    jvi, jgi = js.sparse_mll_and_grad_inducing(jk, Z, X, Y, 0.3, jitter)
    _close(vi, jvi, RTOL_INNER)
    _close(gi, jgi, RTOL_INNER)
    _close(ts.titsias_elbo(tk, Z, X, Y, 0.3, jitter, device="cpu"),
           js.titsias_elbo(jk, Z, X, Y, 0.3, jitter), RTOL_INNER)


def test_more_inducing_than_dense_rejected():
    X, Z, Y = _toy(n=6, m=6)
    with pytest.raises(ValueError, match="higher than the number of sparse"):
        ts.fit_sparse(tg.Gaussian(1.0), np.vstack([Z, Z[:1]]), X, Y, 0.1, device="cpu")


def test_optimize_inducing_trace_matches_jax():
    X, Z, Y = _toy(seed=2)
    z, trace = ts.optimize_inducing(tg.Gaussian(1.5, 1.0), Z, X, Y, 0.3, 1e-8, iterations=10,
                                    learning_rate=0.05, device="cpu")
    jz, jtrace = js.optimize_inducing(jg.Gaussian(1.5, 1.0), Z, X, Y, 0.3, 1e-8, iterations=10,
                                      learning_rate=0.05)
    _close(trace, jtrace, 1e-8)
    _close(z, jz, 1e-8)
    assert float(trace[-1]) > float(trace[0])


@pytest.mark.parametrize("hyper", [True, False])
def test_fit_svgp_matches_jax(hyper):
    X, Z, Y = _toy(seed=3)
    sgp, trace = ts.fit_svgp(tg.Gaussian(1.5, 1.0), Z, X, Y, 0.3, 1e-8, iterations=10,
                             learning_rate=0.05, optimize_hyperparameters=hyper, device="cpu")
    jsgp, jtrace = js.fit_svgp(jg.Gaussian(1.5, 1.0), Z, X, Y, 0.3, 1e-8, iterations=10,
                               learning_rate=0.05, optimize_hyperparameters=hyper)
    _close(trace, jtrace, 1e-8)
    _close(sgp.Z, jsgp.Z, 1e-8)
    _close(sgp.alpha, jsgp.alpha, 1e-8)
    _close(tg.params_vector(sgp.kernel), jg.params_vector(jsgp.kernel), 1e-8)
    if not hyper:
        assert [float(p) for p in sgp.kernel.params] == [1.5, 1.0]


def _jax_state(s):
    return {"kernel": jg.kernel_to_string(s.kernel),
            **{k: np.asarray(getattr(s, k)) for k in ("Z", "X", "Y", "sigma", "jitter", "alpha", "R", "Lmm")}}


def test_save_and_load_across_packages(tmp_path):
    X, Z, Y = _toy(seed=4)
    js_ = js.fit_sparse(jg.Sum(jg.Gaussian(1.2, 0.9), jg.White(0.2)), Z, X, Y, 0.3, 1e-6)
    Xs = np.random.default_rng(6).standard_normal((5, 2))
    # JAX writes, the port reads
    js.save_sparse(js_, str(tmp_path / "jax.npz"))
    got = ts.load_sparse(str(tmp_path / "jax.npz"), device="cpu")
    assert got.route == "loaded"
    _close(got.predict(Xs), js_.predict(Xs), 1e-14)
    _close(got.credible_interval(Xs[0]), js_.credible_interval(Xs[0]), 1e-12)
    # the converter carries the same state
    conv = convert.sparse_from_numpy(_jax_state(js_), device="cpu")
    assert conv.route == "converted"
    _close(conv.predict(Xs), js_.predict(Xs), 1e-14)
    # the port writes, JAX reads (and a float32 load casts every array)
    ts.save_sparse(got, str(tmp_path / "port.npz"))
    back = js.load_sparse(str(tmp_path / "port.npz"))
    assert jg.kernel_to_string(back.kernel) == tg.kernel_to_string(got.kernel)
    for key in ("Z", "X", "Y", "alpha", "R", "Lmm", "sigma", "jitter"):
        np.testing.assert_array_equal(np.asarray(getattr(back, key)), np.asarray(getattr(js_, key)))
    f32 = ts.load_sparse(str(tmp_path / "port.npz"), np.float32, "cpu")
    assert all(getattr(f32, k).dtype == torch.float32 for k in ("Z", "alpha", "R", "Lmm", "sigma"))


def _sparse_posteriors(priors):
    X, Z, Y = _toy(n=64, m=16, d=2, q=2, seed=7)
    jpri = [jp.LogGaussianDensity(0.0, 1.0), None] if priors else None
    tpri = [tp.LogGaussianDensity(0.0, 1.0), None] if priors else None
    jl = jh.make_sparse_gp_log_posterior(jg.Gaussian(1.0, 1.0), Z, X, Y, 0.2, jpri, jitter=1e-4)
    return X, Z, Y, jl, tpri


@pytest.mark.parametrize("priors,use_crout,route", [(False, None, "torch-cholesky"),
                                                     (True, None, "torch-cholesky"),
                                                     (True, True, "fleet-crout")])
def test_sparse_log_posterior_matches_jax_per_chain(priors, use_crout, route):
    X, Z, Y, jl, tpri = _sparse_posteriors(priors)
    tl = th.make_sparse_gp_log_posterior(tg.Gaussian(1.0, 1.0), Z, X, Y, 0.2, tpri, jitter=1e-4,
                                         use_crout=use_crout, device="cpu")
    assert tl.route == route
    z = np.random.default_rng(8).uniform(-1, 1, (5, 2))
    z[3] = [-800.0, 0.2]  # exp underflows to 0: out of range in both packages
    _cuda.reset_launch_counts()
    v, g = th._value_and_grad(tl)(torch.tensor(z))
    assert sum(_cuda.launch_counts().values()) == 0  # the plain versions ran
    jv, jgr = jax.vmap(jax.value_and_grad(jl))(jnp.asarray(z))
    assert np.isnan(np.asarray(jv)[3]) and torch.isnan(v[3]) and torch.isnan(g[3]).all()
    keep = [0, 1, 2, 4]
    _close(v[keep], np.asarray(jv)[keep], RTOL_INNER)
    _close(g[keep], np.asarray(jgr)[keep], RTOL_INNER)
    # the chains never mix: one chain alone gives the same value and gradient
    v1, g1 = th._value_and_grad(tl)(torch.tensor(z[1:2]))
    _close(v1, v[1:2], 1e-13)
    _close(g1, g[1:2], 1e-13)


def test_sparse_log_posterior_is_the_sparse_mll_plus_jacobian():
    X, Z, Y, _, _ = _sparse_posteriors(False)
    tl = th.make_sparse_gp_log_posterior(tg.Gaussian(1.0, 1.0), Z, X, Y, 0.2, jitter=1e-4,
                                         device="cpu")
    z = np.array([[0.3, -0.2]])
    want = ts.sparse_mll_scalar(tg.Gaussian(*np.exp(z[0])), Z, X, Y, 0.2, 1e-4, device="cpu")
    _close(tl(torch.tensor(z))[0], float(want) + z.sum(), 1e-12)
    assert math.isfinite(float(want))
