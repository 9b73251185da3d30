"""The port's sharded samplers (gpr_tpu_torch.parallel.sharded_hmc) and the
multi-rank dry run, on the CPU, at 2 and 4 gloo ranks
(tests/torch_dist_worker.py, one launch of both world sizes for the module).

JAX's sharded samplers are not run here: tests/conftest.py:36-47 records a
jaxlib CPU crash on the largest shard-mapped sampler programs.  So the port
is held to its own one-process samplers, which tests/test_torch_hmc.py and
tests/test_torch_nuts.py hold to JAX:

* the sharded chunked HMC and NUTS equal ``sample_hmc_chunked`` /
  ``sample_nuts_chunked`` bit for bit, with the two-stage and the windowed
  warmup and a remainder chunk (the configurations of
  tests/test_sharded.py:157-247);
* ``sample_hmc_sharded`` (each rank its own stream, the warmup's statistics
  combined over the ranks) is held on a 2-parameter GP posterior to a
  64 x 64 quadrature of JAX's log posterior within 4 Monte Carlo standard
  errors, as ``test_torch_hmc.py`` holds ``sample_hmc``;
* NUTS through ``sample_hmc_sharded`` with windowed warmup on an
  anisotropic Gaussian, as tests/test_sharded.py:281-299 holds JAX's;
* its moment hook against JAX's ``_pmoments`` formula (sharded_hmc.py:81-87)
  on the ranks' inputs, to 1e-12.
"""

import numpy as np
import pytest
import torch

from gpr_tpu_torch.inference import hmc as th
from gpr_tpu_torch.inference import nuts as tn
from gpr_tpu_torch.parallel import sharded_hmc as tsh
from test_torch_hmc import _check_moments, _one_torch_thread, _small_gp, quadrature_moments  # noqa: F401
import torch_dist_worker as worker


@pytest.fixture(scope="module")
def gp_posterior():
    jl, _ = _small_gp()
    return quadrature_moments(jl)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, gp_posterior):
    m_q, _ = gp_posterior
    return worker.launch_worlds("sharded_hmc", (2, 4), tmp_path_factory.mktemp("sharded_hmc"),
                                inputs={"gp_z0": np.tile(m_q, (16, 1))})


@pytest.fixture(params=[2, 4], ids=["D2", "D4"])
def run(request, runs):
    return request.param, runs[request.param]


@pytest.fixture(scope="module")
def one_process():
    """The one-process chunked runs of every bit-for-bit case."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, kind, z0, seed, cfg, chunk in worker.sampler_cases():
            if kind == "hmc":
                out[name] = th.sample_hmc_chunked(worker.standard_normal_logp, torch.tensor(z0), seed,
                                                  th.HMCConfig(**cfg), chunk_size=chunk, device="cpu")
            else:
                out[name] = tn.sample_nuts_chunked(worker.standard_normal_logp, torch.tensor(z0), seed,
                                                   tn.NUTSConfig(**cfg), chunk_size=chunk, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("name", [c[0] for c in worker.sampler_cases()])
def test_sharded_chunked_equals_one_process_bit_for_bit(run, one_process, name):
    _, ranks = run
    ref = one_process[name]
    for r in ranks:
        for field in ref._fields:
            np.testing.assert_array_equal(r[f"{name}_{field}"], getattr(ref, field).numpy(), err_msg=field)


def test_sample_hmc_sharded_matches_quadrature(run, gp_posterior):
    """Every rank returns the same whole result (16 chains, gathered in
    chain order, one adapted step size and mass); its moments lie within 4
    Monte Carlo standard errors of the quadrature's."""
    _, ranks = run
    for k in ("gp_samples", "gp_accept", "gp_step_size", "gp_inv_mass"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k])
    samples = torch.tensor(ranks[0]["gp_samples"])
    assert samples.shape == (16, 100, 2)
    assert 0.5 < float(ranks[0]["gp_accept"].mean()) <= 1.0
    m_q, s_q = gp_posterior
    _check_moments(samples, m_q, s_q)


def test_sample_hmc_sharded_runs_windowed_nuts(run):
    """As tests/test_sharded.py:281-299 holds JAX: NUTS through
    sample_hmc_sharded with windowed warmup on an anisotropic Gaussian; the
    mass from every rank's window moments spans the scales."""
    _, ranks = run
    s = ranks[0]["nuts_sharded_samples"].reshape(-1, 2)
    np.testing.assert_allclose(s.std(0), worker.NUTS_SCALES, rtol=0.35)
    im = ranks[0]["nuts_sharded_inv_mass"]
    assert im[1] / im[0] > 100
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["nuts_sharded_samples"], ranks[0]["nuts_sharded_samples"])


def test_moment_hook_is_jax_pmoments(run):
    """sharded_hmc.py:81-87: E = pmean(mean), Var = pmean(var + mean^2) - E^2
    floored at 1e-12, the count times the ranks."""
    D, ranks = run
    means, vars_ = zip(*(worker.moment_inputs(r) for r in range(D)))
    g_mean = np.mean(means, 0)
    g_var = np.maximum(np.mean(np.array(vars_) + np.array(means) ** 2, 0) - g_mean**2, 1e-12)
    for r in ranks:
        np.testing.assert_allclose(r["mom_mean"], g_mean, rtol=1e-12)
        np.testing.assert_allclose(r["mom_var"], g_var, rtol=1e-12)
        assert int(r["mom_w"]) == 50 * D


def test_indivisible_chains_raise(run):
    _, ranks = run
    for r in ranks:
        assert r["raises"].tolist() == [True] * 3


def test_dryrun_multichip_runs(run):
    """``parallel.dryrun_multichip`` on a (D/2 x 2) chains x data mesh: the
    data-sharded fit, one chain-sharded HMC transition, the n=1024 sharded
    fit within its float32 bounds of the one-process fit, the chunked
    samplers (NUTS bit for bit), the sharded fleet."""
    _, ranks = run
    for r in ranks:
        assert float(r["dryrun_alpha_err"]) < 5e-3 and float(r["dryrun_logdet_err"]) < 1e-4
        assert 0.0 <= float(r["dryrun_mean_accept"]) <= 1.0


def test_chain_scaling_efficiency():
    assert tsh.chain_scaling_efficiency({1: 100.0, 2: 180.0, 4: 320.0}) == {2: 0.9, 4: 0.8}
    assert tsh.chain_scaling_efficiency({2: 1.0}) == {}
