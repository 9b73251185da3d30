"""The port's mixture predictive (gpr_tpu_torch.inference.predictive) against
gpr_tpu's, on the CPU.

The same theta draws go through both packages' ``predictive`` at S = 8,
n = 128, m = 32: float64 agrees to 1e-10 relative on the fleet route's
plain versions (``use_crout=True``: K6's and K7's plain versions), as on
torch's route; float32 on the plain K6 / K7 versions agrees to 3e-5 (the
well-conditioned fleet of tests/test_torch_batched.py, cond ~ 1e2 times
float32's eps).  ``subsample_draws`` picks JAX's indices.  A draw whose
Gram is singular is retried with jitter and leaves the others as JAX has
them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from gpr_tpu.inference import hmc as jh
from gpr_tpu.inference import predictive as jpred
from gpr_tpu_torch.inference import hmc as th
from gpr_tpu_torch.inference import predictive as tpred
from gpr_tpu_torch.ops import _cuda

from test_torch_hmc import _one_torch_thread  # noqa: F401


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _problem(n=128, m=32, S=8, q=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 6, (n, 2))
    Y = np.stack([np.sin(X.sum(1)), np.cos(X[:, 0])], 1)[:, :q] + 0.05 * rng.standard_normal((n, q))
    Xs = rng.uniform(0, 6, (m, 2))
    theta = np.stack([rng.uniform(0.8, 2.0, S), rng.uniform(0.5, 1.5, S)], 1)
    return X, Y, Xs, theta


@pytest.mark.parametrize("num", [1, 7, 32, 100])
@pytest.mark.parametrize("chains,T", [(1, 10), (4, 25), (8, 63), (3, 101)])
def test_subsample_draws_picks_jax_indices(chains, T, num):
    samples = np.random.default_rng(chains * T).standard_normal((chains, T, 2))
    a = tpred.subsample_draws(torch.tensor(samples), num)
    b = jpred.subsample_draws(jnp.asarray(samples), num)
    # the same rows (torch's and XLA's exp may differ in the last ulp; a row
    # one off would differ by O(1))
    assert _rel(a, b) < 1e-14


@pytest.mark.parametrize("include_noise", [True, False])
@pytest.mark.parametrize("use_crout", [True, False])
def test_predictive_matches_jax_float64(include_noise, use_crout):
    X, Y, Xs, theta = _problem()
    j = jpred.predictive(jg.Gaussian(1.0, 1.0), jnp.asarray(theta), X, Y, Xs, 0.1, include_noise)
    _cuda.reset_launch_counts()
    t = tpred.predictive(tg.Gaussian(1.0, 1.0), torch.tensor(theta), X, Y, Xs, 0.1, include_noise,
                         use_crout=use_crout, device="cpu")
    assert sum(_cuda.launch_counts().values()) == 0
    for a, b in zip(t, j):
        assert _rel(a, b) < 1e-10


def test_predictive_float32_plain_kernels():
    X, Y, Xs, theta = _problem(seed=1)
    f32 = [np.asarray(a, np.float32) for a in (X, Y, Xs)]
    j = jpred.predictive(jg.Gaussian(1.0, 1.0), jnp.asarray(theta), X, Y, Xs, 0.5)
    t = tpred.predictive(tg.Gaussian(1.0, 1.0), torch.tensor(theta), *f32[:2], f32[2], 0.5,
                         use_crout=True, device="cpu")
    assert t.mean.dtype == torch.float32
    for a, b in zip(t, j):
        assert _rel(a, b) < 3e-5


def test_predictive_per_draw_sigma_and_a_singular_draw():
    X, Y, Xs, theta = _problem(seed=2)
    X[1] = X[0]  # two equal rows: with sigma 0 that draw's Gram is singular
    sig = np.array([0.1, 0.0, 0.2, 0.05, 0.1, 0.1, 0.3, 0.1])
    j = jpred.predictive(jg.Gaussian(1.0, 1.0), jnp.asarray(theta), X, Y, Xs, jnp.asarray(sig))
    t = tpred.predictive(tg.Gaussian(1.0, 1.0), torch.tensor(theta), X, Y, Xs, torch.tensor(sig),
                         use_crout=True, device="cpu")
    # the singular draw factors with jitter (its values are rounding-bound,
    # cond ~ 1 / eps); the others keep JAX's values
    assert np.isfinite(t.mean.numpy()).all() and (t.variance_per_draw[1] >= 0).all()
    others = np.array([0, 2, 3, 4, 5, 6, 7])
    assert _rel(t.mean_per_draw[others], j.mean_per_draw[others]) < 1e-10
    assert _rel(t.variance_per_draw[others], j.variance_per_draw[others]) < 1e-10


def test_predictive_from_hmc():
    X, Y, Xs, _ = _problem()
    samples = np.log(np.random.default_rng(3).uniform(0.8, 1.6, (2, 20, 2)))
    jres = jh.HMCResult(samples=jnp.asarray(samples), accept_rate=jnp.ones(2),
                        step_size=jnp.asarray(0.1), inv_mass=jnp.ones(2))
    tres = th.HMCResult(samples=torch.tensor(samples), accept_rate=torch.ones(2),
                        step_size=torch.tensor(0.1), inv_mass=torch.ones(2))
    j = jpred.predictive_from_hmc(jg.Gaussian(1.0, 1.0), jres, X, Y, Xs, 0.1, num_draws=8)
    t = tpred.predictive_from_hmc(tg.Gaussian(1.0, 1.0), tres, X, Y, Xs, 0.1, num_draws=8,
                                  device="cpu")
    for a, b in zip(t, j):
        assert _rel(a, b) < 1e-10
