"""The port's multi-rank layer (gpr_tpu_torch.parallel.sharded_gram,
gp.batched.fit_batched_sharded, inference.predictive.predictive_sharded)
against JAX's sharded functions, on the CPU.

The port's ranks are 2 and 4 gloo processes (tests/torch_dist_worker.py,
one launch per world size for the module; a FileStore in the test's
temporary directory, one intra-op thread a rank).  The oracle is JAX in
this process on the first 2 or 4 of conftest's 8 virtual CPU devices, in
float64, on the same inputs.  A row-sharded result is the ranks' blocks
concatenated in rank order; a replicated one must be the same on every
rank.  Tolerance: 1e-9 relative to the largest entry (float64; the
schedules match, only the sums' order may differ).  JAX's functions run
under ``jax.jit``: one compiled program a call, where eager ``shard_map``
compiles op by op (10-20x slower here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gpr_tpu as jg
from gpr_tpu.gp import batched as jbatched
from gpr_tpu.inference import predictive as jpred
from gpr_tpu.parallel import sharded_gram as jsg
from test_torch_hmc import _one_torch_thread  # noqa: F401
import torch_dist_worker as worker

RTOL = 1e-9


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worker.launch_worlds("parallel", (2, 4), tmp_path_factory.mktemp("parallel"))


@pytest.fixture(params=[2, 4], ids=["D2", "D4"])
def run(request, runs):
    return request.param, runs[request.param]


def _close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-300))


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _same(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def test_sharded_gram_matches_jax(run):
    D, ranks = run
    mesh = jsg.default_mesh(D)
    K = jax.jit(lambda X: jsg.sharded_gram(jg.Gaussian(1.5, 1.0), X, mesh))(jnp.asarray(worker.gram_inputs()))
    _close(_rows(ranks, "gram"), K)


def test_cholesky_sharded_matches_jax(run):
    D, ranks = run
    mesh = jsg.default_mesh(D)
    L = jax.jit(lambda A: jsg.cholesky_sharded(A, mesh))(jnp.asarray(worker.spd(128, 0)))
    _close(_rows(ranks, "chol"), L)


def test_cho_solve_sharded_matches_jax(run):
    D, ranks = run
    L, B = worker.solve_inputs()
    mesh = jsg.default_mesh(D)
    X = jax.jit(lambda L, B: jsg.cho_solve_sharded(L, B, mesh))(jnp.asarray(L), jnp.asarray(B))
    _close(_same(ranks, "solve"), X)


def test_fit_sharded_matches_jax(run):
    D, ranks = run
    X, Y = worker.fit_inputs()
    mesh = jsg.default_mesh(D)
    alpha, logdet, L = jax.jit(lambda X, Y: jsg.fit_sharded(jg.Gaussian(1.1, 0.8), X, Y, 0.2, mesh))(
        jnp.asarray(X), jnp.asarray(Y))
    _close(_same(ranks, "fit_alpha"), alpha)
    _close(_same(ranks, "fit_logdet"), logdet)
    _close(_rows(ranks, "fit_L"), L)


def test_sharded_gram_in_row_runs_matches_jax(run):
    """The Gram made in runs of 5 rows (``_GRAM_CHUNK`` set small), runs
    that divide no block row."""
    D, ranks = run
    mesh = jsg.default_mesh(D)
    K = jax.jit(lambda X: jsg.sharded_gram(jg.Gaussian(1.5, 1.0), X, mesh))(jnp.asarray(worker.gram_inputs()))
    _close(_rows(ranks, "gram_runs"), K)


def test_fit_sharded_in_row_runs_matches_jax(run):
    """fit_sharded with its Gram made in runs of 24 rows."""
    D, ranks = run
    X, Y = worker.fit_inputs()
    mesh = jsg.default_mesh(D)
    alpha, logdet, L = jax.jit(lambda X, Y: jsg.fit_sharded(jg.Gaussian(1.1, 0.8), X, Y, 0.2, mesh))(
        jnp.asarray(X), jnp.asarray(Y))
    _close(_same(ranks, "fit_runs_alpha"), alpha)
    _close(_same(ranks, "fit_runs_logdet"), logdet)
    _close(_rows(ranks, "fit_runs_L"), L)


def test_sharded_factors_keep_their_input(run):
    """cholesky_sharded and safe_cholesky_sharded factor a copy: the
    caller's K (the rank's rows, or all of K) is unchanged, as in JAX."""
    _, ranks = run
    for r in ranks:
        assert r["inputs_kept"].tolist() == [True] * 5


@pytest.mark.parametrize("case", ["healthy", "zeros", "singular", "negative"])
def test_safe_cholesky_sharded_escalates_like_jax(run, case):
    """tests/test_sharded.py:317's contract: no jitter on a healthy K; on a
    singular K (zeros: the first try; rank 59 of 64: the third) JAX's jitter
    and the factor after the escalation; a K that never factors (-I) NaN
    after the last try, with JAX's jitter.  The rank-59 K's last 5 pivots
    are ~1e-6, set by rounding (one ulp of K moves them by ~1e-3 relative),
    so there the factor's first 59 columns are compared, and both factors
    must reproduce K + jitter I to 1e-12 of its largest entry."""
    D, ranks = run
    K = worker.safe_inputs()[case]
    mesh = jsg.default_mesh(D)
    L, j = jax.jit(lambda K: jsg.safe_cholesky_sharded(K, mesh))(jnp.asarray(K))
    assert float(_same(ranks, f"safe_{case}_jitter")) == float(j)
    Lp = _rows(ranks, f"safe_{case}_L")
    if case == "negative":
        assert np.isnan(Lp[-1, -1]) and np.isnan(np.asarray(L)[-1, -1])
        assert float(j) == pytest.approx(np.finfo(np.float64).eps * 1e5, rel=1e-12)
    elif case == "singular":
        assert float(j) > 0.0
        _close(Lp[:, :59], np.asarray(L)[:, :59])
        Kj = K + float(j) * np.eye(64)
        for F in (Lp, np.asarray(L)):
            _close(F @ F.T, Kj, rtol=1e-12)
    else:
        _close(Lp, L)
        assert (float(j) == 0.0) == (case == "healthy")


@pytest.mark.parametrize("case", ["fleet", "fleet_crout", "fleet_bk"])
def test_fit_batched_sharded_matches_jax(run, case):
    """The rank's members on fit_batched's route (torch-cholesky, or
    fleet-crout's plain panel sweep with use_crout=True), a per-member
    kernel with batched_kernel=True; JAX's sharded fleet on its CPU route."""
    D, ranks = run
    X, Y, sig, ls, sc = worker.fleet_inputs()
    kern = jg.Gaussian(jnp.asarray(ls), jnp.asarray(sc)) if case == "fleet_bk" else jg.Gaussian(1.2, 0.9)
    gp = jbatched.fit_batched_sharded(kern, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(sig),
                                      mesh=jsg.default_mesh(D, "fleet"), axis="fleet",
                                      batched_kernel=case == "fleet_bk")
    _close(_rows(ranks, f"{case}_alpha"), gp.alpha)
    _close(_rows(ranks, f"{case}_L"), gp.L)
    assert str(_same(ranks, f"{case}_route")) == ("fleet-crout" if case == "fleet_crout" else "torch-cholesky")


def test_predictive_sharded_matches_jax(run):
    D, ranks = run
    theta, X, Y, Xs = worker.predictive_inputs()
    mesh = jsg.default_mesh(D, "draws")
    res = jax.jit(lambda t: jpred.predictive_sharded(jg.Gaussian(1.0, 1.0), t, jnp.asarray(X), jnp.asarray(Y),
                                                     jnp.asarray(Xs), 0.1, mesh=mesh))(jnp.asarray(theta))
    _close(_same(ranks, "pred_mean"), res.mean)
    _close(_same(ranks, "pred_var"), res.variance)
    _close(_rows(ranks, "pred_mpd"), res.mean_per_draw)
    _close(_rows(ranks, "pred_vpd"), res.variance_per_draw)


def test_indivisible_sizes_raise(run):
    """As JAX raises ValueError: n for the Gram and the fit, B for the
    fleet, S for the predictive, none divisible by the mesh."""
    _, ranks = run
    for r in ranks:
        assert r["raises"].tolist() == [True] * 4
