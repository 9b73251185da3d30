"""The port's ADVI (gpr_tpu_torch.inference.advi) against gpr_tpu's, on the CPU.

The optimization is held to JAX's on JAX's own noise: ``advi._run`` takes
the (num_steps, num_samples, dim) draws JAX's key flow gives
(advi.py:79-92), and its ELBO trace and variational parameters must agree
to 1e-9 relative (torch's Adam and optax's adam sum their bias corrections
in another order, a few ulp a step).  The analytic targets are checked as
tests/test_advi.py checks JAX; on the 2-parameter GP posterior the mean
must lie within 4 Monte Carlo standard errors of quadrature of JAX's log
posterior, the standard error being the posterior standard deviation over
the square root of the ELBO's samples a step (mean-field VI under-covers
the variance, so the standard deviation is only checked for its order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.inference import advi as ja
from gpr_tpu_torch.inference import advi as ta

from test_torch_hmc import (_one_torch_thread, _posteriors, _small_gp,  # noqa: F401
                            quadrature_moments)


def _jax_noise(key, num_steps, num_samples, dim):
    return np.stack([np.asarray(jax.random.normal(k, (num_samples, dim), jnp.float64))
                     for k in jax.random.split(key, num_steps)])


@pytest.mark.parametrize("target", ["gauss", "gp"])
def test_advi_optimization_matches_jax_on_its_noise(target):
    if target == "gp":
        jl, tl = _posteriors(n=64, priors=True)
        z0, steps, lr = np.array([0.1, -0.2]), 25, 0.05
    else:
        scales = np.array([0.5, 2.0])

        def jl(z):
            return -0.5 * jnp.sum((z / scales) ** 2)

        def tl(z):
            return -0.5 * ((z / torch.tensor(scales)) ** 2).sum(-1)

        z0, steps, lr = np.array([0.7, -0.4]), 60, 0.1
    key = jax.random.PRNGKey(5)
    jr = ja.fit_advi(jl, jnp.asarray(z0), key, num_steps=steps, num_samples=4, learning_rate=lr)
    noise = torch.tensor(_jax_noise(key, steps, 4, 2))
    tr = ta._run(tl, torch.tensor(z0), noise, lr, -2.0)
    for a, b in ((tr.elbo_trace, jr.elbo_trace), (tr.mean, jr.mean), (tr.std, jr.std)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_cosine_schedule_matches_optax():
    import optax

    sched = optax.cosine_decay_schedule(0.05, 37)
    for k in (0, 1, 18, 36, 37, 50):
        assert abs(ta._cosine_decay(0.05, 37, k) - float(sched(k))) <= 1e-17


def test_standard_normal_recovery():
    def logp(z):
        return -0.5 * (z * z).sum(-1)

    res = ta.fit_advi(logp, np.array([0.7, -0.4]), 0, num_steps=600, num_samples=16,
                      learning_rate=0.05, device="cpu")
    np.testing.assert_allclose(res.mean.numpy(), [0.0, 0.0], atol=0.08)
    np.testing.assert_allclose(res.std.numpy(), [1.0, 1.0], atol=0.12)
    # the unnormalized 2-D standard normal: ELBO -> log Z = log(2 pi)
    assert abs(float(res.elbo) - np.log(2 * np.pi)) < 0.8
    assert float(res.elbo_trace[-1]) > float(res.elbo_trace[0])
    draws = res.sample(torch.Generator().manual_seed(0), 5)
    assert draws.shape == (5, 2) and draws.dtype == torch.float64


def test_anisotropic_scales():
    scales = torch.tensor([0.5, 2.0], dtype=torch.float64)
    res = ta.fit_advi(lambda z: -0.5 * ((z / scales) ** 2).sum(-1), np.zeros(2), 1,
                      num_steps=800, num_samples=16, device="cpu")
    np.testing.assert_allclose(res.std.numpy(), scales.numpy(), rtol=0.25)


def test_advi_gp_posterior_matches_quadrature():
    jl, tl = _small_gp()
    m_q, s_q = quadrature_moments(jl)
    S = 8
    res = ta.fit_advi(tl, m_q + 1.0, 2, num_steps=300, num_samples=S, learning_rate=0.1,
                      device="cpu")
    assert np.isfinite(res.elbo_trace.numpy()).all()
    assert float(res.elbo_trace[-20:].mean()) > float(res.elbo_trace[:20].mean())
    assert (np.abs(res.mean.numpy() - m_q) <= 4 * s_q / np.sqrt(S)).all(), (res.mean, m_q, s_q)
    assert ((res.std.numpy() > 0.2 * s_q) & (res.std.numpy() < 2 * s_q)).all(), (res.std, s_q)
