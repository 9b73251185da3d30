"""The port's NUTS (gpr_tpu_torch.inference.nuts) against gpr_tpu's, on the CPU.

One NUTS transition (max_depth 4) is fed the momentum, the directions and
the uniforms that JAX's key flow draws (nuts.py:169-200) and held to JAX's
own transition at rtol 1e-10 in float64, on the GP log posterior of
tests/test_torch_hmc.py and on a Gaussian target.  JAX integrates every one
of the 2^4 - 1 leaves; the port stops once no chain still builds a live
trajectory, and the same step without stopping gives the same state bit
for bit (checked on the Gaussian target, where a leaf is cheap).  Whole runs are checked in distribution: an analytic Gaussian and
the 2-parameter GP posterior against quadrature of JAX's log posterior
within 4 Monte Carlo standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu_torch as tg
from gpr_tpu.inference import hmc as jh
from gpr_tpu.inference import nuts as jn
from gpr_tpu_torch.inference import hmc as th
from gpr_tpu_torch.inference import nuts as tn

from test_torch_hmc import (_check_moments, _close, _gauss_target, _one_torch_thread,  # noqa: F401
                            _posteriors, _small_gp, quadrature_moments)


def _jax_nuts_draws(key, C, dim, D, dtype=jnp.float64):
    """The draws JAX's _nuts_transition takes from each chain's key."""
    normal, direction, u_leaf, u_swap = [], [], [], []
    for kc in jax.random.split(key, C):
        k_mom, k_loop = jax.random.split(kc)
        normal.append(np.asarray(jax.random.normal(k_mom, (dim,), dtype)))
        dirs, leaves, swaps = [], [], []
        for depth, kd in enumerate(jax.random.split(k_loop, D)):
            k_dir, k_sub, k_swap = jax.random.split(kd, 3)
            dirs.append(1.0 if bool(jax.random.bernoulli(k_dir)) else -1.0)
            key = k_sub
            for _ in range(2**depth):
                key, k_acc = jax.random.split(key)
                leaves.append(float(jax.random.uniform(k_acc, ())))
            swaps.append(float(jax.random.uniform(k_swap, ())))
        direction.append(dirs)
        u_leaf.append(leaves)
        u_swap.append(swaps)
    t = torch.tensor
    return tn.NUTSDraws(t(np.stack(normal)), t(direction, dtype=torch.float64),
                        t(u_leaf, dtype=torch.float64), t(u_swap, dtype=torch.float64))


@pytest.mark.parametrize("target", ["gp", "gauss"])
def test_nuts_transition_matches_jax_on_its_draws(target):
    D = 4
    if target == "gp":
        jl, tl = _posteriors(priors=True)
        dim, eps = 2, 0.05
        z0 = np.random.default_rng(8).uniform(-0.5, 0.5, (4, dim))
    else:
        jl, tl, _, _ = _gauss_target()
        dim, eps = 3, 0.3
        z0 = np.random.default_rng(8).standard_normal((4, dim))
    jcfg, tcfg = jn.NUTSConfig(max_depth=D), tn.NUTSConfig(max_depth=D)
    inv_mass = np.linspace(0.7, 1.3, dim)
    jst = jh.init_chains(jl, jnp.asarray(z0))
    tst = th.init_chains(tl, torch.tensor(z0))
    vg = jax.value_and_grad(jl)
    jstep = jax.jit(jax.vmap(lambda s, k: jn._nuts_transition(
        vg, s, k, jnp.asarray(eps), jnp.asarray(inv_mass), jcfg)))
    f = th._value_and_grad(tl)
    key = jax.random.PRNGKey(3)
    for t in range(1 if target == "gp" else 2):
        key, kt = jax.random.split(key)
        draws = _jax_nuts_draws(kt, 4, dim, D)
        jst, jacc = jstep(jst, jax.random.split(kt, 4))
        args = (f, tst, draws, torch.tensor(eps, dtype=torch.float64), torch.tensor(inv_mass), tcfg)
        tst, tacc = tn._nuts_step(*args)
        if target == "gauss" and t == 0:  # every leaf integrated, as JAX does: the same state
            full, full_acc = tn._nuts_step(*args, stop_early=False)
            for a, b in zip((*full, full_acc), (*tst, tacc)):
                assert torch.equal(a, b)
        _close(tacc, jacc)
        _close(tst.z, jst.z)
        _close(tst.logp, jst.logp)
        _close(tst.grad, jst.grad)


def test_nuts_stops_early_where_every_chain_turned():
    _, tlogp, _, _ = _gauss_target()
    calls = []

    def counted(z):
        calls.append(z.shape[0])
        return tlogp(z)

    f = th._value_and_grad(counted)
    st = th.init_chains(tlogp, torch.zeros(3, 3, dtype=torch.float64))
    cfg = tn.NUTSConfig(max_depth=8)
    draws = tn._nuts_draws(torch.Generator().manual_seed(0), st, cfg)
    tn._nuts_step(f, st, draws, torch.tensor(0.5, dtype=torch.float64), torch.ones(3,
                                                                                 dtype=torch.float64), cfg)
    # a standard-normal-like target turns long before 2^8 - 1 leaves
    assert 0 < len(calls) < 2**8 - 1


def test_nuts_standard_normal():
    _, tlogp, mu, sd = _gauss_target()
    cfg = tn.NUTSConfig(num_warmup=200, num_samples=300, max_depth=6)
    res = tg.sample_nuts(tlogp, np.zeros((4, 3)), 0, cfg, device="cpu")
    flat = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), mu, atol=0.15)
    np.testing.assert_allclose(flat.std(0), sd, atol=0.2)
    assert 0.5 < float(res.accept_rate.mean()) <= 1.0
    assert (th.split_rhat(res.samples) < 1.1).all()


def test_nuts_chunked_equals_unchunked():
    _, tlogp, _, _ = _gauss_target()
    cfg = tn.NUTSConfig(num_warmup=20, num_samples=11, max_depth=4)
    a = tn.sample_nuts(tlogp, np.zeros((2, 3)), 4, cfg, device="cpu")
    b = tg.sample_nuts_chunked(tlogp, np.zeros((2, 3)), 4, cfg, chunk_size=4, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def small_gp():
    jl, tl = _small_gp()
    return jl, tl, quadrature_moments(jl)


def test_nuts_gp_posterior_matches_quadrature(small_gp):
    jl, tl, (m_q, s_q) = small_gp
    cfg = tn.NUTSConfig(num_warmup=50, num_samples=60, max_depth=4)
    res = tn.sample_nuts(tl, np.tile(m_q, (8, 1)), 7, cfg, device="cpu")
    assert 0.5 < float(res.accept_rate.mean()) <= 1.0
    _check_moments(res.samples, m_q, s_q)
