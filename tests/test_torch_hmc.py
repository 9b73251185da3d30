"""The port's HMC (gpr_tpu_torch.inference.hmc) and its safe fleet factor
(ops.batched.factor_solve_safe) against gpr_tpu's, on the CPU.

Exact checks run in float64 at rtol 1e-10: the log posterior's value and
gradient per chain on the ``fleet-crout`` route (the plain K7 version), the
safe factor's jitter, one HMC transition fed the momentum, step counts and
uniforms that JAX's key flow draws (hmc.py:215-234), the dual-averaging
warmup driven by one deterministic transition in both packages, the window
schedule, the mass, the diagnostics and the checkpoints.  The samplers'
own draws come from a torch generator, so whole runs are checked in
distribution: analytic targets as tests/test_hmc.py holds JAX, and a
2-parameter GP posterior whose moments are held to a 64 x 64 quadrature of
JAX's log posterior within 4 Monte Carlo standard errors (the quadrature
standard deviation over the square root of the run's effective sample
size).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from gpr_tpu.inference import hmc as jh
from gpr_tpu.inference import priors as jp
from gpr_tpu.ops import linalg as jlin
from gpr_tpu_torch.inference import hmc as th
from gpr_tpu_torch.inference import priors as tp
from gpr_tpu_torch.ops import _cuda
from gpr_tpu_torch.ops import batched as tob

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the samplers run thousands of small ops: one intra-op thread per test
    # process keeps the parallel suite's workers from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _gp_data(n=128, seed=0):
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 10, n)[:, None]
    return X, np.sin(X) + 0.1 * rng.standard_normal((n, 1))


def _posteriors(n=128, priors=False, weight=1.0):
    X, Y = _gp_data(n)
    jpri = [jp.LogGaussianDensity(0.0, 1.0), None] if priors else None
    tpri = [tp.LogGaussianDensity(0.0, 1.0), None] if priors else None
    jl = jh.make_gp_log_posterior(jg.Gaussian(1.0, 1.0), X, Y, 0.1, jpri, weight)
    tl = th.make_gp_log_posterior(tg.Gaussian(1.0, 1.0), X, Y, 0.1, tpri, weight,
                                  use_crout=True, device="cpu")
    return jl, tl


@pytest.mark.parametrize("priors,weight", [(False, 1.0), (True, 1.0), (True, 0.5)])
def test_log_posterior_value_and_grad_match_jax(priors, weight):
    jl, tl = _posteriors(priors=priors, weight=weight)
    assert tl.route == "fleet-crout"
    z = np.random.default_rng(1).uniform(-1, 1, (4, 2))
    _cuda.reset_launch_counts()
    v, g = th._value_and_grad(tl)(torch.tensor(z))
    assert sum(_cuda.launch_counts().values()) == 0  # the plain versions ran
    jv, jgr = jax.vmap(jax.value_and_grad(jl))(jnp.asarray(z))
    _close(v, jv)
    _close(g, jgr)
    # the chains never mix: one chain alone gives the same value and gradient
    v1, g1 = th._value_and_grad(tl)(torch.tensor(z[2:3]))
    _close(v1, v[2:3], 1e-13)
    _close(g1, g[2:3], 1e-13)


def test_log_posterior_out_of_range_chain_is_nan_and_does_not_raise():
    _, tl = _posteriors()
    z = np.random.default_rng(2).uniform(-1, 1, (4, 2))
    bad = z.copy()
    bad[1, 0] = -800.0  # exp underflows to 0: the kernel classes would raise
    bad[3, 1] = math.inf
    v, g = th._value_and_grad(tl)(torch.tensor(bad))
    assert torch.isnan(v[[1, 3]]).all() and torch.isnan(g[[1, 3]]).all()
    v0, g0 = th._value_and_grad(tl)(torch.tensor(z))
    _close(v[[0, 2]], v0[[0, 2]], 1e-13)
    _close(g[[0, 2]], g0[[0, 2]], 1e-13)


def _fleet_K(B=4, n=64, fail=1, never=None, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, 2))
    K = np.exp(-0.5 * ((X[:, :, None] - X[:, None]) ** 2).sum(-1)) + 0.01 * np.eye(n)
    # a member with its least eigenvalue at -1e-12 and its diagonal mean
    # below 1: JAX's schedule eps * 10^k first passes it at k = 4, far from
    # any factorization's rounding (~n eps = 1.4e-14)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(0.1, 1.0, n)
    lam[0] = -1e-12
    K[fail] = (Q * lam) @ Q.T
    if never is not None:
        K[never, 5, 5] = -1e4  # indefinite beyond any jitter of the schedule
    return K


@pytest.mark.parametrize("route", ["fleet-crout", "fleet-fused", "torch-cholesky"])
def test_safe_factor_retries_failed_member_with_jax_jitter(route):
    K = _fleet_K()
    Y = np.random.default_rng(4).standard_normal((4, 64, 2))
    Lj, jitter_j = jlin.safe_cholesky(jnp.asarray(K))
    panel = 32
    L, alpha, jitter = tob.factor_solve_safe(torch.tensor(K), torch.tensor(Y), route, panel)
    jit_np = np.asarray(jitter_j)
    assert jit_np[1] == np.finfo(np.float64).eps * 1e4 and (np.delete(jit_np, 1) == 0).all()
    _close(jitter, jit_np, 1e-12)
    _close(L, Lj, 1e-8)
    truth = np.linalg.solve(K + jit_np[:, None, None] * np.eye(64), Y)
    _close(alpha[[0, 2, 3]], truth[[0, 2, 3]], 1e-8)
    # the members that factored at once keep the route's own outputs bit for bit
    L0, a0, _ = tob._attempt(route, torch.tensor(K), torch.tensor(Y), panel)
    assert torch.equal(L[[0, 2, 3]], L0[[0, 2, 3]]) and torch.equal(alpha[[0, 2, 3]], a0[[0, 2, 3]])


@pytest.mark.parametrize("route", ["fleet-crout", "torch-cholesky"])
def test_safe_factor_gives_zero_gradient_to_a_member_that_never_factors(route):
    K = _fleet_K(fail=1, never=2)
    Y = np.random.default_rng(5).standard_normal((4, 64, 1))
    Kt = torch.tensor(K, requires_grad=True)
    L, alpha, jitter = tob.factor_solve_safe(Kt, torch.tensor(Y), route, 32)
    assert not torch.isfinite(L[2, -1, -1]) and torch.isfinite(L[[0, 1, 3], -1, -1]).all()
    obj = (torch.nan_to_num(alpha, nan=0.0) ** 2).sum() + torch.log(
        torch.nan_to_num(torch.diagonal(L, dim1=1, dim2=2), nan=1.0)).sum()
    (gK,) = torch.autograd.grad(obj, Kt)
    assert (gK[2] == 0).all() and torch.isfinite(gK).all()
    # the others' gradients are those of a fleet without the failed member
    Kt2 = torch.tensor(K[[0, 3]], requires_grad=True)
    L2, a2, _ = tob.factor_solve_safe(Kt2, torch.tensor(Y[[0, 3]]), route, 32)
    (g2,) = torch.autograd.grad((a2**2).sum() + torch.log(torch.diagonal(L2, dim1=1, dim2=2)).sum(),
                                Kt2)
    _close(gK[[0, 3]], g2, 1e-12)


def test_safe_factor_success_path_matches_the_route_pullback():
    K = _fleet_K(fail=0, seed=7)
    K[0] = K[1] + 0.1 * np.eye(64)
    Y = np.random.default_rng(6).standard_normal((4, 64, 3))
    grads = []
    for fn in (lambda A, B: tob.factor_solve_safe(A, B, "fleet-crout", 32)[:2],
               lambda A, B: tob.factor_solve_batched_diff(A, B, 32)):
        Kt, Yt = torch.tensor(K, requires_grad=True), torch.tensor(Y, requires_grad=True)
        L, alpha = fn(Kt, Yt)
        grads.append(torch.autograd.grad((alpha * Yt).sum() + torch.log(
            torch.diagonal(L, dim1=1, dim2=2)).sum(), (Kt, Yt)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _jax_hmc_draws(key, C, dim, cfg, dtype=jnp.float64):
    normal, steps, u = [], [], []
    for kc in jax.random.split(key, C):
        k_mom, k_steps, k_acc = jax.random.split(kc, 3)
        normal.append(np.asarray(jax.random.normal(k_mom, (dim,), dtype)))
        steps.append(int(jax.random.randint(k_steps, (), 1, cfg.num_leapfrog + 1)))
        u.append(float(jax.random.uniform(k_acc, ())))
    return th.HMCDraws(torch.tensor(np.stack(normal)),
                       torch.tensor(steps) if cfg.jitter_steps else None, torch.tensor(u))


def _gauss_target():
    mu = np.array([1.0, -2.0, 0.5])
    sd = np.array([0.5, 1.5, 1.0])

    def jlogp(z):
        return -0.5 * jnp.sum(((z - mu) / sd) ** 2)

    def tlogp(z):
        return -0.5 * (((z - torch.tensor(mu)) / torch.tensor(sd)) ** 2).sum(-1)

    return jlogp, tlogp, mu, sd


@pytest.mark.parametrize("target,jitter_steps", [("gp", True), ("gauss", True), ("gauss", False)])
def test_hmc_transition_matches_jax_on_its_draws(target, jitter_steps):
    if target == "gp":
        jl, tl = _posteriors(priors=True)
        dim, eps, L = 2, 0.05, 6
        z0 = np.random.default_rng(8).uniform(-0.5, 0.5, (4, dim))
    else:
        jl, tl, _, _ = _gauss_target()
        dim, eps, L = 3, 0.4, 8
        z0 = np.random.default_rng(8).standard_normal((4, dim))
    cfg = th.HMCConfig(num_leapfrog=L, jitter_steps=jitter_steps)
    jcfg = jh.HMCConfig(num_leapfrog=L, jitter_steps=jitter_steps)
    inv_mass = np.linspace(0.6, 1.4, dim)
    key = jax.random.PRNGKey(11)
    jst = jh.init_chains(jl, jnp.asarray(z0))
    tst = th.init_chains(tl, torch.tensor(z0))
    _close(tst.logp, jst.logp)
    accepted = 0
    for t in range(3):
        key, kt = jax.random.split(key)
        draws = _jax_hmc_draws(kt, 4, dim, cfg)
        jst, jacc = jax.vmap(lambda s, k: jh._hmc_transition(
            jax.value_and_grad(jl), s, k, jnp.asarray(eps), jnp.asarray(inv_mass), jcfg))(
                jst, jax.random.split(kt, 4))
        tst, tacc = th._hmc_step(th._value_and_grad(tl), tst, draws, torch.tensor(eps, dtype=torch.float64),
                                 torch.tensor(inv_mass), cfg)
        _close(tacc, jacc)
        _close(tst.z, jst.z)
        _close(tst.logp, jst.logp)
        _close(tst.grad, jst.grad)
        accepted += int((np.asarray(jacc) > 0.2).sum())
    assert accepted > 0


def test_leapfrog_keeps_finished_chains_exactly():
    _, tlogp, _, _ = _gauss_target()
    f = th._value_and_grad(tlogp)
    z = torch.tensor(np.random.default_rng(9).standard_normal((3, 3)))
    p = torch.tensor(np.random.default_rng(10).standard_normal((3, 3)))
    _, g = f(z)
    im = torch.ones(3, dtype=torch.float64)
    out = th._leapfrog(f, z, p, g, 0.1, im, torch.tensor([2, 5, 1]))
    for c, k in enumerate((2, 5, 1)):
        one = th._leapfrog(f, z[c:c + 1], p[c:c + 1], g[c:c + 1], 0.1, im, k)
        for a, b in zip(out, one):
            assert torch.equal(a[c:c + 1], b)


def _det_transitions(weights):
    """The same deterministic transition in both packages: z moves by
    eps * inv_mass * w, and the accept statistic is exp(-w eps)."""

    def jt(s, k, eps, im):
        w = s.logp
        return jh.ChainState(z=s.z + eps * im * w, logp=s.logp, grad=s.grad), jnp.exp(-w * eps)

    def tt(s, g, eps, im):
        w = s.logp
        return th.ChainState(z=s.z + eps * im * w[:, None], logp=s.logp, grad=s.grad), \
            torch.exp(-w * eps)

    return jt, tt


@pytest.mark.parametrize("windowed", [False, True])
def test_warmup_dual_averaging_matches_jax(windowed):
    C, dim = 5, 2
    rng = np.random.default_rng(12)
    z0, w = rng.standard_normal((C, dim)), rng.uniform(0.2, 3.0, C)
    jt, tt = _det_transitions(w)
    jst = jh.ChainState(z=jnp.asarray(z0), logp=jnp.asarray(w), grad=jnp.zeros((C, dim)))
    tst = th.ChainState(z=torch.tensor(z0), logp=torch.tensor(w), grad=torch.zeros(C, dim,
                                                                                  dtype=torch.float64))
    # one stage alone: the step size, every draw and every mean accept
    inv_mass = np.array([0.5, 2.0])
    js, jeps, jzs, jacc = jh._warmup_scan(None, jst, jax.random.PRNGKey(0), jnp.asarray(0.1),
                                          jnp.asarray(inv_mass), jh.HMCConfig(), 40, 0.8,
                                          transition=jt)
    ts, teps, tzs, tacc = th._warmup_scan(None, tst, None, torch.tensor(0.1, dtype=torch.float64),
                                          torch.tensor(inv_mass), th.HMCConfig(), 40, 0.8,
                                          transition=tt)
    for a, b in ((teps, jeps), (tzs, jzs), (tacc, jacc), (ts.z, js.z)):
        _close(a, b)
    # the whole adaptation: step size and mass
    jcfg = jh.HMCConfig(num_warmup=120, windowed_warmup=windowed, max_step_size=3.0)
    tcfg = th.HMCConfig(num_warmup=120, windowed_warmup=windowed, max_step_size=3.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    js, jeps, jim = jh._adapt_phase(None, jst, k1, k2, jcfg, dim, jnp.float64, None, None,
                                    transition=jt)
    ts, teps, tim = th._adapt_phase(None, tst, None, tcfg, dim, torch.float64, None, None,
                                    transition=tt)
    _close(teps, jeps)
    _close(tim, jim)
    _close(ts.z, js.z)


@pytest.mark.parametrize("num_warmup", [1, 7, 20, 100, 500, 1000, 2345])
def test_window_schedule_matches_jax(num_warmup):
    assert th._window_schedule(num_warmup) == jh._window_schedule(num_warmup)


@pytest.mark.parametrize("n_chains", [1, 3, 7, 8, 13])
def test_shrunk_mass_and_tree_mean_match_jax(n_chains):
    zs = np.random.default_rng(n_chains).standard_normal((10, n_chains, 3))
    for drop in (0, 5):
        _close(th._shrunk_mass(torch.tensor(zs), drop), jh._shrunk_mass(jnp.asarray(zs), drop=drop))
    v = zs[0, :, 0]
    assert float(th._tree_mean(torch.tensor(v))) == float(jh._tree_mean(jnp.asarray(v)))


def _draws(seed=13, c=4, t=64, d=2):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((c, t, d)), 1) * 0.1 + rng.standard_normal((c, t, d))
    return x


def test_diagnostics_match_jax():
    x = _draws(t=40)
    stuck = x.copy()
    stuck[:, :, 1] = 0.3  # a stuck dimension: zero variance
    # JAX's lag loop is traced once, not run op by op
    jess = jax.jit(jh.effective_sample_size, static_argnames="max_lag")
    for s in (x, stuck):
        _close(th.effective_sample_size(torch.tensor(s)), jess(jnp.asarray(s)))
        _close(th.effective_sample_size(torch.tensor(s), max_lag=5), jess(jnp.asarray(s), max_lag=5))
    _close(th.split_rhat(torch.tensor(x)), jh.split_rhat(jnp.asarray(x)))
    one = x[:, :1]
    _close(th.effective_sample_size(torch.tensor(one)), jh.effective_sample_size(jnp.asarray(one)))
    ts, js = th.posterior_summary(torch.tensor(x)), jax.jit(jh.posterior_summary)(jnp.asarray(x))
    assert set(ts) == set(js)
    for k in js:
        _close(ts[k], js[k])


@pytest.mark.parametrize("with_states", [False, True])
def test_checkpoints_load_across_packages(tmp_path, with_states):
    rng = np.random.default_rng(14)
    arrays = dict(samples=rng.standard_normal((3, 5, 2)), accept_rate=rng.uniform(size=3),
                  step_size=np.float64(0.3), inv_mass=rng.uniform(size=2))
    st = dict(z=rng.standard_normal((3, 2)), logp=rng.standard_normal(3),
              grad=rng.standard_normal((3, 2)))
    jres = jh.HMCResult(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tres = th.HMCResult(**{k: torch.tensor(v) for k, v in arrays.items()})
    jst = jh.ChainState(**{k: jnp.asarray(v) for k, v in st.items()}) if with_states else None
    tst = th.ChainState(**{k: torch.tensor(v) for k, v in st.items()}) if with_states else None
    jh.save_chain_checkpoint(str(tmp_path / "jax"), jres, jst)
    th.save_chain_checkpoint(str(tmp_path / "port"), tres, tst)
    # each package loads the other's file
    r1, s1 = th.load_chain_checkpoint(str(tmp_path / "jax.npz"), device="cpu")
    r2, s2 = jh.load_chain_checkpoint(str(tmp_path / "port.npz"))
    for a, b in ((r1, jres), (r2, tres)):
        for k in arrays:
            assert np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)))
    assert (s1 is None) == (s2 is None) == (not with_states)
    if with_states:
        for k in st:
            assert np.array_equal(np.asarray(getattr(s1, k)), st[k])
            assert np.array_equal(np.asarray(getattr(s2, k)), st[k])
    assert sorted(np.load(tmp_path / "jax.npz").files) == sorted(np.load(tmp_path / "port.npz").files)


def test_resume_continues_with_the_adapted_kernel(tmp_path):
    _, tlogp, mu, sd = _gauss_target()
    cfg = th.HMCConfig(num_warmup=60, num_samples=20, num_leapfrog=6)
    res = th.sample_hmc(tlogp, np.zeros((4, 3)), 0, cfg, device="cpu")
    th.save_chain_checkpoint(str(tmp_path / "ck"), res)
    more = th.resume_hmc(tlogp, str(tmp_path / "ck.npz"), 1, 30, cfg, device="cpu")
    assert more.samples.shape == (4, 30, 3)
    assert float(more.step_size) == float(res.step_size)
    assert torch.equal(more.inv_mass, res.inv_mass)
    assert bool(torch.isfinite(more.samples).all())


def test_chunked_equals_unchunked_and_validates_chunk_size():
    _, tlogp, _, _ = _gauss_target()
    cfg = th.HMCConfig(num_warmup=30, num_samples=25, num_leapfrog=5)
    z0 = np.zeros((3, 3))
    a = th.sample_hmc(tlogp, z0, 5, cfg, device="cpu")
    for chunk in (7, 25, 0, 100):
        b = th.sample_hmc_chunked(tlogp, z0, 5, cfg, chunk_size=chunk, device="cpu")
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    with pytest.raises(TypeError):
        th.sample_hmc_chunked(tlogp, z0, 5, cfg, chunk_size=2.5, device="cpu")


def test_hmc_standard_normal():
    """As tests/test_hmc.py holds JAX: the moments of an analytic Gaussian."""
    _, tlogp, mu, sd = _gauss_target()
    cfg = th.HMCConfig(num_warmup=300, num_samples=600, num_leapfrog=8)
    res = tg.sample_hmc(tlogp, np.zeros((4, 3)), 0, cfg, device="cpu")
    flat = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), mu, atol=0.15)
    np.testing.assert_allclose(flat.std(0), sd, atol=0.2)
    assert 0.5 < float(res.accept_rate.mean()) <= 1.0
    assert (th.split_rhat(res.samples) < 1.1).all()
    assert (th.effective_sample_size(res.samples) > 100).all()


# ---------------------------------------------------------------------------
# a 2-parameter GP posterior against quadrature of JAX's log posterior
# ---------------------------------------------------------------------------

def _small_gp():
    X, Y = _gp_data(32, seed=21)
    pri = [(0.0, 1.0), (0.0, 1.0)]
    jl = jh.make_gp_log_posterior(jg.Gaussian(1.0, 1.0), X, Y, 0.1,
                                  [jp.LogGaussianDensity(*p) for p in pri])
    tl = th.make_gp_log_posterior(tg.Gaussian(1.0, 1.0), X, Y, 0.1,
                                  [tp.LogGaussianDensity(*p) for p in pri], device="cpu")
    return jl, tl


def quadrature_moments(jl, grid=64):
    """(mean, sd) of z under exp(jl) on a 64 x 64 grid over +-6 sd of a
    coarse first grid's moments."""
    f = jax.jit(jax.vmap(jl))

    def moments(lo, hi):
        a = np.linspace(lo[0], hi[0], grid)
        b = np.linspace(lo[1], hi[1], grid)
        A, B = np.meshgrid(a, b, indexing="ij")
        Z = np.stack([A.ravel(), B.ravel()], 1)
        lp = np.asarray(f(jnp.asarray(Z)))
        w = np.exp(lp - lp.max())
        w /= w.sum()
        m = (w[:, None] * Z).sum(0)
        return m, np.sqrt((w[:, None] * (Z - m) ** 2).sum(0))

    m, s = moments(np.array([-3.0, -3.0]), np.array([3.0, 3.0]))
    return moments(m - 6 * s, m + 6 * s)


def _check_moments(samples, m_q, s_q, k=4.0):
    ess = th.effective_sample_size(samples).numpy()
    flat = samples.reshape(-1, samples.shape[-1]).numpy()
    mcse = s_q / np.sqrt(ess)
    assert (np.abs(flat.mean(0) - m_q) <= k * mcse).all(), (flat.mean(0), m_q, mcse)
    # the variance's standard error, sd^2 sqrt(2 / ess) for a near-Gaussian
    assert (np.abs(flat.var(0) - s_q**2) <= k * s_q**2 * np.sqrt(2.0 / ess)).all(), \
        (flat.std(0), s_q)


@pytest.fixture(scope="module")
def small_gp():
    jl, tl = _small_gp()
    return jl, tl, quadrature_moments(jl)


def test_hmc_gp_posterior_matches_quadrature(small_gp):
    jl, tl, (m_q, s_q) = small_gp
    cfg = th.HMCConfig(num_warmup=60, num_samples=100, num_leapfrog=4)
    res = th.sample_hmc(tl, np.tile(m_q, (16, 1)), 3, cfg, device="cpu")
    assert 0.5 < float(res.accept_rate.mean()) <= 1.0
    _check_moments(res.samples, m_q, s_q)
