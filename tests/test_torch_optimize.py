"""The port's MLE / MAP training (gpr_tpu_torch.inference.optimize) against
gpr_tpu's, on the CPU in float64.

Adam: torch.optim.Adam with its defaults and optax.adam(lr) are one rule
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias correction);
they round in other places, so over 20 steps the trace, the parameters
and the final value agree to 1e-8 relative.

Gauss-Newton: the reference's update is pinv(g g^T) g with singular values
at or below eps (an absolute threshold) zeroed.  g g^T has rank one, so its
second singular value is rounding noise of about eps |g|^2: with |g|^2 ~ 100,
as the sinus problem's MLL gradient has, that noise straddles the threshold
and the step depends on the last bits of g, in either package.  The
trajectory is invariant to the objective's weight in exact arithmetic (the
weight cancels in pinv(g g^T) g * value), so the rank-one cases (every
``optimize``, and ``optimize2`` with one output) run at weight 0.01, where
the noise lies far below the threshold, and then agree to 1e-10.
``optimize2`` with two outputs has a full-rank J^T J and runs at weight 1.
With priors the gradient holds their log-derivatives, which the weight does
not scale, so those cases take broad priors whose log-derivatives are small.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from gpr_tpu.gp import likelihood as jlk
from gpr_tpu.inference import optimize as jo
from gpr_tpu.inference import priors as jpr
from gpr_tpu_torch import convert
from gpr_tpu_torch.gp import likelihood as tlk
from gpr_tpu_torch.inference import optimize as to

REL = 1e-8


def _sinus(n=12, noise=0.05, seed=19):
    xs = np.arange(n) * 2 * math.pi / n
    ys = np.sin(xs) + noise * np.random.default_rng(seed).standard_normal(n)
    return xs[:, None], ys[:, None]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _prior_pair():
    tree = ("LogGaussianDensity", [0.5, 0.7])
    return [jpr.LogGaussianDensity(*tree[1]), None], [convert.density_from_numpy(tree), None]


def _broad_priors():
    trees = [("GaussianDensity", [1.2, 10.0]), ("GammaDensity", [1.05, 0.05])]
    return ([getattr(jpr, n)(*a) for n, a in trees],
            [convert.density_from_numpy(t) for t in trees])


@pytest.mark.parametrize("kind", ["mle", "map"])
@pytest.mark.parametrize("log_space", [True, False])
def test_adam_matches_optax(kind, log_space):
    X, Y = _sinus()
    kw = dict(iterations=20, learning_rate=0.03, log_space=log_space)
    if kind == "mle":
        kj, rj = jo.fit_mle(jg.Gaussian(0.7, 1.0), X, Y, 0.1, **kw)
        kt, rt = to.fit_mle(tg.Gaussian(0.7, 1.0), X, Y, 0.1, device="cpu", **kw)
    else:
        pj, pt = _prior_pair()
        kj, rj = jo.fit_map(jg.Gaussian(0.7, 1.0), X, Y, 0.1, pj, weight=0.8, **kw)
        kt, rt = to.fit_map(tg.Gaussian(0.7, 1.0), X, Y, 0.1, pt, weight=0.8, device="cpu", **kw)
    assert rt.trace.shape == (20,) and rt.route == "torch-cholesky"
    assert _rel(rt.trace, rj.trace) < REL
    assert _rel(rt.params, rj.params) < REL
    assert abs(rt.value - rj.value) <= REL * abs(rj.value)
    assert kt.to_string() == tg.Gaussian(*[float(p) for p in rt.params]).to_string()
    # the trace starts at the initial parameters and the value is taken at the
    # returned ones
    X_t, Y_t = torch.tensor(X), torch.tensor(Y)
    if kind == "mle":
        start = tlk.mll_scalar(tg.Gaussian(0.7, 1.0), X_t, Y_t, 0.1)
        assert float(rt.trace[0]) == pytest.approx(float(start), rel=1e-12)
        assert rt.value == pytest.approx(float(tlk.mll_scalar(kt, X_t, Y_t, 0.1)), rel=1e-12)


def test_fit_mle_on_the_blocked_route():
    rng = np.random.default_rng(20)
    X = rng.standard_normal((1100, 2))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((1100, 1))
    kj, rj = jo.fit_mle(jg.Gaussian(1.5, 1.0), X, Y, 0.1, iterations=3, learning_rate=0.05)
    kt, rt = to.fit_mle(tg.Gaussian(1.5, 1.0), X, Y, 0.1, iterations=3, learning_rate=0.05,
                        device="cpu")
    assert rt.route == "blocked"
    assert _rel(rt.trace, rj.trace) < REL and _rel(rt.params, rj.params) < REL


def test_non_finite_gradients_step_by_zero():
    # no jitter factors Linear(1, -100)'s K: the value is NaN, the gradient 0
    X, Y = _sinus()
    kt, rt = to.fit_mle(tg.Linear(1.0, -100.0), X, Y, 0.1, iterations=3, log_space=False,
                        device="cpu")
    kj, rj = jo.fit_mle(jg.Linear(1.0, -100.0), X, Y, 0.1, iterations=3, log_space=False)
    np.testing.assert_array_equal(rt.params.numpy(), [1.0, -100.0])
    np.testing.assert_array_equal(rt.params.numpy(), np.asarray(rj.params))
    assert not torch.isfinite(rt.trace).any() and math.isnan(rt.value)


def test_mle_finds_the_grid_optimum_and_predicts():
    # reference tests/GaussianLikelihoodTest.cpp:57-153 (cf.
    # tests/test_likelihood_priors.py::test_brute_force_vs_gradient_mle)
    X, Y = _sinus(noise=0.05, seed=42)
    grid = np.linspace(0.5, 4.0, 36)
    vals = [float(tlk.mll_scalar(tg.Gaussian(s, 1.0), X, Y, 0.1, device="cpu")) for s in grid]
    kstar, _ = to.fit_mle(tg.Gaussian(0.7, 1.0), X, Y, 0.1, iterations=300, learning_rate=0.03,
                          device="cpu")
    assert abs(float(kstar.sigma) - grid[int(np.argmax(vals))]) < 0.5
    gp = tg.fit(kstar, X, Y, sigma=0.1, device="cpu")
    xt = np.linspace(0, 2 * math.pi, 50, endpoint=False)[:, None]
    err = np.mean(np.abs(gp.predict(torch.tensor(xt)).numpy()[:, 0] - np.sin(xt[:, 0])))
    assert err < 0.2


def _gn_pair(start, Y, weight, priors=None, exp_params=False, iterations=8):
    X = (np.arange(10) * 2 * math.pi / 10)[:, None]
    pj, pt = (None, None) if priors is None else priors
    jvg, jvj = jo.reference_objective(jg.Gaussian(*start), jnp.asarray(X), jnp.asarray(Y), 0.1,
                                      priors=pj, weight=weight, exp_params=exp_params)
    tvg, tvj = to.reference_objective(tg.Gaussian(*start), X, Y, 0.1, priors=pt, weight=weight,
                                      exp_params=exp_params, device="cpu")
    p0 = [0.0, 0.0] if exp_params else list(start)
    return (jo.GaussNewtonInference(jvg, p0, 0.1, iterations, objective_value_and_jacobian=jvj),
            to.GaussNewtonInference(tvg, p0, 0.1, iterations, objective_value_and_jacobian=tvj))


_X10 = np.arange(10) * 2 * math.pi / 10
Y1 = np.sin(_X10)[:, None]
Y2 = np.stack([np.sin(_X10), np.cos(_X10)], 1)


@pytest.mark.parametrize("method", ["optimize", "optimize2"])
@pytest.mark.parametrize("mask", [None, [True, False], [False, True]])
@pytest.mark.parametrize("Y", [Y1, Y2], ids=["q1", "q2"])
def test_gauss_newton_trajectories_match_jax(method, mask, Y):
    start = [3.0, 1.0] if method == "optimize2" else [1.0, 1.0]
    full_rank = method == "optimize2" and Y.shape[1] == 2
    oj, ot = _gn_pair(start, Y, 1.0 if full_rank else 0.01)
    if mask is not None:
        oj.set_parameters_to_optimize(mask)
        ot.set_parameters_to_optimize(mask)
    pj, pt = np.asarray(getattr(oj, method)()), getattr(ot, method)().numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-10, atol=1e-10)
    if mask is not None:
        frozen = mask.index(False)
        assert pt[frozen] == start[frozen] and pt[1 - frozen] != start[1 - frozen]


@pytest.mark.parametrize("exp_params", [False, True])
def test_gauss_newton_with_priors_matches_jax(exp_params):
    oj, ot = _gn_pair([1.0, 1.0], Y1, 0.01, priors=_broad_priors(), exp_params=exp_params)
    for method in ("optimize", "optimize2"):
        np.testing.assert_allclose(getattr(ot, method)().numpy(),
                                   np.asarray(getattr(oj, method)()), rtol=1e-10, atol=1e-10)
    # the value and gradient callables themselves
    vj, gj = oj._vg(jnp.asarray([0.3, 0.2]))
    vt, gt = ot._vg(torch.tensor([0.3, 0.2], dtype=torch.float64))
    assert _rel(vt, vj) < 1e-12 and _rel(gt, gj) < 1e-12
    vj, Jj = oj._vj(jnp.asarray([0.3, 0.2]))
    vt, Jt = ot._vj(torch.tensor([0.3, 0.2], dtype=torch.float64))
    assert _rel(vt, vj) < 1e-12 and _rel(Jt, Jj) < 1e-12


def test_optimize2_needs_a_jacobian():
    ot = to.GaussNewtonInference(lambda p: (None, None), [1.0], 0.1, 3)
    with pytest.raises(ValueError):
        ot.optimize2()


def test_jax_side_of_the_rank_one_case_is_ill_posed():
    # why the rank-one cases run at weight 0.01: at weight 1 the second
    # singular value of g g^T is of the order of eps itself
    X = (np.arange(10) * 2 * math.pi / 10)[:, None]
    _, g = jlk.mll_value_and_grad(jg.Gaussian(1.0, 1.0), X, Y1, 0.1)
    s = np.linalg.svd(np.outer(g, g), compute_uv=False)
    assert s[0] > 50 and s[1] < 1e-13
