"""The port's linear algebra (gpr_tpu_torch.ops.linalg) against
gpr_tpu.ops.linalg, in float64 on the CPU.

Factors and solves: 1e-10 relative (same algorithm, other summation order).
The jitter chosen by escalation must be the same value in both packages:
both start from the same eps-scaled head-diagonal mean and grow it 10x.
"""

import numpy as np
import pytest
import torch

from gpr_tpu.ops import linalg as jl
from gpr_tpu_torch.ops import linalg as tl


def _spd(n, seed=0):
    B = np.random.default_rng(seed).standard_normal((n, n))
    return B @ B.T + n * np.eye(n)


def _singular(n, seed=0):
    # rank n-5, shifted to a smallest eigenvalue of -3e-13: no factorization
    # without jitter, none at the first two jitters (~1.2e-14, ~1.2e-13) and a
    # clear one at the third (~1.2e-12), whatever the rounding of either LAPACK
    B = np.random.default_rng(seed).standard_normal((n, n - 5))
    return B @ B.T - 3e-13 * np.eye(n)


@pytest.mark.parametrize("n", [40, 300])
def test_safe_cholesky_clean(n):
    A = _spd(n)
    L, j = tl.safe_cholesky(torch.tensor(A))
    Lj, jj = jl.safe_cholesky(A)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-10, atol=1e-10 * n)
    assert float(j) == float(jj) == 0.0


@pytest.mark.parametrize("initial", [0.0, 1e-9])
def test_safe_cholesky_escalates_like_jax(initial):
    A = _singular(60)
    L, j = tl.safe_cholesky(torch.tensor(A), initial_jitter=initial)
    Lj, jj = jl.safe_cholesky(A, initial_jitter=initial)
    assert float(j) > 0.0
    assert float(j) == pytest.approx(float(jj), rel=1e-12)
    # the last pivots are ~1e-6, so the factors themselves differ in their
    # last columns; each reconstructs A + jitter I to rounding
    Ln = L.numpy()
    np.testing.assert_allclose(Ln @ Ln.T, A + float(j) * np.eye(len(A)), rtol=0, atol=1e-12 * 60)


def test_safe_cholesky_batched_escalates_per_element():
    A = np.stack([_spd(30, 1), _singular(30, 2)])
    L, j = tl.safe_cholesky(torch.tensor(A))
    Lj, jj = jl.safe_cholesky(A)
    assert float(j[0]) == 0.0 and float(j[1]) > 0.0
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=1e-12)
    np.testing.assert_allclose(L[0].numpy(), np.linalg.cholesky(A[0]), rtol=1e-10, atol=1e-10)


def test_never_factoring_comes_back_nan():
    A = -np.eye(8)
    L, _ = tl.safe_cholesky(torch.tensor(A), max_tries=2)
    assert not torch.isfinite(L[-1, -1])


def test_solves_logdet_and_diagonal():
    A = _spd(50, 3)
    b = np.random.default_rng(4).standard_normal((50, 3))
    L = torch.linalg.cholesky(torch.tensor(A))
    np.testing.assert_allclose(tl.cho_solve(L, torch.tensor(b)).numpy(),
                               np.asarray(jl.cho_solve(L.numpy(), b)), rtol=1e-10)
    np.testing.assert_allclose(tl.cho_solve(L, torch.tensor(b[:, 0])).numpy(),
                               np.linalg.solve(A, b[:, 0]), rtol=1e-10)
    np.testing.assert_allclose(tl.solve_psd(torch.tensor(A), torch.tensor(b)).numpy(),
                               np.asarray(jl.solve_psd(A, b)), rtol=1e-10)
    assert float(tl.logdet_from_chol(L)) == pytest.approx(float(jl.logdet_from_chol(L.numpy())),
                                                          rel=1e-12)
    # the clamp is the reference's long-double range, not float32's
    huge = torch.diag(torch.full((10,), 1e300, dtype=torch.float64))
    assert float(tl.logdet_from_chol(huge)) == pytest.approx(11356.523406294143)
    Ab = torch.tensor(np.stack([A, 2 * A]))
    np.testing.assert_array_equal(tl.add_diagonal(Ab, torch.tensor([1.0, 2.0])).numpy(),
                                  np.asarray(jl.add_diagonal(Ab.numpy(), np.array([1.0, 2.0]))))


def test_routes():
    assert tl.cholesky_route(torch.eye(512)) == "torch-cholesky"
    assert tl.cholesky_route(torch.eye(1024)) == "blocked"  # a CPU tensor
    assert tl.cholesky_route(torch.eye(1024, dtype=torch.float64)) == "blocked"
    assert tl.cholesky_route(torch.eye(1024)[None]) == "torch-cholesky"  # a batch


@pytest.mark.parametrize("n", [40, 1100])  # the direct and the blocked route
def test_safe_cholesky_pullback_matches_jax(n):
    import jax

    A = _spd(n, 5) / n
    Lbar = np.tril(np.random.default_rng(6).standard_normal((n, n)))
    At = torch.tensor(A, requires_grad=True)
    L, _ = tl.safe_cholesky(At)
    (gt,) = torch.autograd.grad(L, At, torch.tensor(Lbar))
    _, vjp = jax.vjp(lambda M: jl.safe_cholesky(M)[0], A)
    (gj,) = vjp(Lbar)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-9 * np.abs(gj).max())
    np.testing.assert_array_equal(gt.numpy(), gt.numpy().T)  # symmetrized, as XLA's rule


def test_pullback_of_a_never_factoring_matrix_is_zero():
    A = torch.tensor(-np.eye(8), requires_grad=True)
    L, _ = tl.safe_cholesky(A, max_tries=2)
    (g,) = torch.autograd.grad(L.sum(), A, allow_unused=True)
    assert torch.equal(g, torch.zeros_like(g))


def test_logdet_clamp_has_jax_s_gradient():
    import jax

    for d in (1e-300, 0.5, 1e300):  # log|A| = 40 log d: below, inside and above the clamp
        L = np.diag(np.full(20, d))
        Lt = torch.tensor(L, requires_grad=True)
        (gt,) = torch.autograd.grad(tl.logdet_from_chol(Lt), Lt)
        gj = np.asarray(jax.grad(lambda M: jl.logdet_from_chol(M))(L))
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-12, atol=0)
        assert (d == 0.5) == bool(torch.any(gt != 0))


def test_inverse_pinv_symmetrize_match_jax():
    A = _spd(30, 7)
    np.testing.assert_allclose(tl.inv_psd(torch.tensor(A)).numpy(), np.asarray(jl.inv_psd(A)),
                               rtol=1e-10, atol=1e-14)
    # full rank with the default threshold; rank 3 of 5 with a threshold far
    # above the rounding noise of the two zero singular values (at the default
    # eps that noise would straddle the threshold in either package)
    rng = np.random.default_rng(8)
    B = rng.standard_normal((5, 5))
    np.testing.assert_allclose(tl.pinv(torch.tensor(B)).numpy(), np.asarray(jl.pinv(B)),
                               rtol=1e-9, atol=1e-12)
    B = rng.standard_normal((5, 3)) @ rng.standard_normal((3, 5))
    np.testing.assert_allclose(tl.pinv(torch.tensor(B), 1e-8).numpy(),
                               np.asarray(jl.pinv(B, 1e-8)), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(tl.symmetrize(torch.tensor(B)).numpy(),
                                  np.asarray(jl.symmetrize(B)))


def test_chol_schedule_switches(monkeypatch):
    # GPR_CHOL_SCHEDULE read at call time (linalg.py:72-118): recursive skips
    # the fused factor; inplace takes the in-place schedule (rows 16-18) for
    # float32 n % 512 == 0 on any device, as JAX's gate has no backend in it,
    # and sends the rest to the blocked routes; GPR_CHOL_LEAF_INV=1 turns the
    # blocked routes into their leaf-kernel forms (row 9) and leaves inplace
    f32 = torch.float32
    assert tl.route_for(2048, f32, "cuda") == "fused-matrix"
    monkeypatch.setenv("GPR_CHOL_SCHEDULE", "recursive")
    assert tl.route_for(2048, f32, "cuda") == "blocked-syrk"
    assert tl.cholesky_route(torch.eye(2048)) == "blocked"
    monkeypatch.setenv("GPR_CHOL_SCHEDULE", "inplace")
    assert tl.route_for(2048, f32, "cuda") == "inplace"
    assert tl.cholesky_route(torch.eye(1024)) == "inplace"
    L, jitter = tl.safe_cholesky(torch.eye(1024))
    assert float(jitter) == 0.0 and torch.equal(L, torch.eye(1024))
    assert tl.route_for(1100, f32, "cuda") == "blocked-syrk"  # JAX's inplace gate: n % 512
    assert tl.route_for(2048, torch.float64, "cuda") == "blocked"
    assert tl.route_for(2048, torch.float64, "cpu") == "blocked"
    assert tl.route_for(512, f32, "cuda") == "torch-cholesky"
    monkeypatch.delenv("GPR_CHOL_SCHEDULE")
    monkeypatch.setenv("GPR_CHOL_LEAF_INV", "1")
    assert tl.cholesky_route(torch.eye(1100)) == "blocked-leaf"
    assert tl.route_for(1100, f32, "cuda") == "blocked-syrk-leaf"
    assert tl.route_for(1100, torch.float64, "cuda") == "blocked-leaf"
    assert tl.cholesky_route(torch.eye(512)) == "torch-cholesky"
    monkeypatch.setenv("GPR_CHOL_SCHEDULE", "inplace")
    assert tl.route_for(2048, f32, "cuda") == "inplace"
    assert tl.route_for(2048, f32, "cpu") == "inplace"
    assert tl.route_for(1100, f32, "cuda") == "blocked-syrk-leaf"
    monkeypatch.delenv("GPR_CHOL_SCHEDULE")
    monkeypatch.setenv("GPR_CHOL_LEAF_INV", "0")
    assert tl.cholesky_route(torch.eye(1100)) == "blocked"


def test_leaf_inv_switch_leaves_the_fused_route(monkeypatch):
    # JAX reads GPR_CHOL_LEAF_INV only inside cholesky_blocked (blocked.py:
    # 309-357); its fused kernel, taken first, ignores it
    monkeypatch.setenv("GPR_CHOL_LEAF_INV", "1")
    f32 = torch.float32
    assert tl.route_for(2048, f32, "cuda") == "fused-matrix"
    for n, device, route in ((2100, "cuda", "blocked-syrk-leaf"), (2048, "cpu", "blocked-leaf")):
        assert tl.route_for(n, f32, device) == route


def test_tri_solve_matches_jax():
    A = _spd(1100, 7)
    L = np.linalg.cholesky(A)
    B = np.random.default_rng(8).standard_normal((1100, 3))
    np.testing.assert_allclose(tl._tri_solve(torch.tensor(L), torch.tensor(B)).numpy(),
                               np.asarray(jl._tri_solve(L, B, trans=False)), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [300, 1100])
def test_chol_lower_matches_jax(n):
    """The factor on the route (torch-cholesky, blocked), no jitter: a
    matrix that does not factor comes back NaN at its last entry in both."""
    A = _spd(n, 11)
    np.testing.assert_allclose(tl.chol_lower(torch.tensor(A)).numpy(), np.asarray(jl.chol_lower(A)),
                               rtol=0, atol=1e-10 * np.sqrt(np.abs(A).max()))
    A[3, 3] = -1.0
    assert np.isnan(float(tl.chol_lower(torch.tensor(A))[-1, -1]))
    assert np.isnan(float(np.asarray(jl.chol_lower(A))[-1, -1]))


def test_cho_solve_takes_two_triangular_solves_at_large_n(monkeypatch):
    """The dispatch settled on the H100 (phase 30 (d)): above JAX's blocked
    threshold, and for a narrow right-hand side, cho_solve stays two
    torch.linalg.solve_triangular, bit for bit, and never the blocked solve."""
    from gpr_tpu_torch.ops import blocked

    def refuse(*a, **k):
        raise AssertionError("cho_solve took the blocked solve")

    monkeypatch.setattr(blocked, "cho_solve_blocked", refuse)
    monkeypatch.setattr(blocked, "solve_triangular_blocked", refuse)
    L = torch.linalg.cholesky(torch.tensor(_spd(1100, 12)))
    for q in (1, 8, 128):
        B = torch.tensor(np.random.default_rng(q).standard_normal((1100, q)))
        assert tl.solve_route(L, B) == "triangular"
        y = torch.linalg.solve_triangular(L, B, upper=False)
        assert torch.equal(tl.cho_solve(L, B), torch.linalg.solve_triangular(L.mT, y, upper=True))
    assert torch.equal(tl._tri_solve(L, B), torch.linalg.solve_triangular(L, B, upper=False))
