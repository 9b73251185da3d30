"""The port's blocked Cholesky (gpr_tpu_torch.ops.blocked) against
gpr_tpu.ops.blocked.cholesky_blocked, both with leaf 128, on the CPU.

The JAX package takes its Pallas SYRK only on a TPU; here its dispatch is
forced on for every f32 update that fits its 128-tiles, in interpret mode,
as tests/test_ops.py:196-215 does (the port's float32 updates run K5's plain
version on the CPU).  Same split points and leaves in both, so the factors
agree to 1e-12 in float64 and 1e-5 in float32 (relative to the largest
entry: the same algorithm with sums in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu.ops.blocked as jblk
import gpr_tpu.ops.pallas_syrk as jsyrk
from gpr_tpu_torch.ops import _cuda, blocked, linalg

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture
def jax_syrk_on(monkeypatch):
    calls = []
    orig = jsyrk.syrk_update

    def interpreted(*args, **kw):
        calls.append(args[1].shape)
        return orig(*args, **{**kw, "interpret": True})

    monkeypatch.setattr(jblk, "_syrk_tiles", lambda: (128, 128))
    monkeypatch.setattr(jblk, "_syrk_usable", lambda m2, m, dtype: dtype == jnp.float32
                        and m2 % 128 == 0 and m % 128 == 0)
    monkeypatch.setattr(jsyrk, "syrk_update", interpreted)
    return calls


def _spd(n, dtype, seed=14):
    B = np.random.default_rng(seed).standard_normal((n, n))
    return (B @ B.T / n + np.eye(n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [600, 1100])
def test_blocked_matches_jax(n, dtype, jax_syrk_on):
    A = _spd(n, dtype)
    Lj = np.asarray(jblk.cholesky_blocked(jnp.asarray(A), leaf=128))
    An = torch.tensor(A)
    An[torch.triu(torch.ones_like(An, dtype=torch.bool), 1)] = float("nan")  # lower-only read
    _cuda.reset_launch_counts()
    L = blocked.cholesky_blocked(An, leaf=128).numpy()
    assert _cuda.launch_counts()["syrk_update"] == 0
    assert np.all(np.triu(L, 1) == 0)  # exact zeros, not the NaN of the input
    assert np.abs(L - np.tril(Lj)).max() <= TOL[dtype] * np.abs(Lj).max()
    if dtype == np.float32:
        assert jax_syrk_on  # the JAX side went through its Pallas SYRK


def test_split_points_are_jax_s():
    for n in (129, 600, 1100, 1920, 3773, 16383, 16384):
        assert blocked._round_split(n) == jblk._round_split(n)
    # n = 3773 with the 1024 leaf: three trailing updates (1853 x 1920,
    # 896 x 1024, 829 x 1024) in the recursion
    assert blocked._round_split(3773) == 1920 and blocked._round_split(1920) == 1024
    assert blocked._round_split(1853) == 1024 and blocked.LEAF == 1024


@pytest.mark.parametrize("where", [5, 1099])
def test_failed_pivot_reaches_the_last_diagonal(where):
    A = _spd(1100, np.float64)
    A[where, where] = -1e3
    L = blocked.cholesky_blocked(torch.tensor(A), leaf=128)
    assert not torch.isfinite(L[-1, -1])


def test_routes_on_the_cpu():
    assert linalg.cholesky_route(torch.zeros((1100, 1100))) == "blocked"
    assert linalg.cholesky_route(torch.zeros((1100, 1100), dtype=torch.float64)) == "blocked"
    assert linalg.cholesky_route(torch.zeros((1023, 1023))) == "torch-cholesky"
    assert linalg.route_for(1100, torch.float32, torch.device("cuda")) == "blocked-syrk"
    assert linalg.route_for(1152, torch.float32, "cuda") == "fused-matrix"
    assert linalg.route_for(3773, torch.float64, "cuda") == "blocked"
    A = torch.tensor(_spd(1100, np.float64))
    L, j = linalg.safe_cholesky(A)
    assert float(j) == 0.0
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(A.numpy()), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the blocked solves, the block tree and the study schedules against JAX's
# (float64, the shapes of tests/test_ops.py:57, 384-408, 579-590)
# ---------------------------------------------------------------------------

def _close64(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("n,q", [(64, 4), (500, 4), (96, 3), (500, 1)])
def test_solve_triangular_blocked_matches_jax(n, q, lower):
    """Leaf 128 in both, so 500 recurses (split 256, then 128)."""
    L = np.linalg.cholesky(_spd(n, np.float64, seed=1))
    T = L if lower else L.T.copy()
    B = np.random.default_rng(2).standard_normal((n, q))
    B = B[:, 0] if q == 1 else B
    X = blocked.solve_triangular_blocked(torch.tensor(T), torch.tensor(B), lower=lower, leaf=128)
    _close64(X, jblk.solve_triangular_blocked(jnp.asarray(T), jnp.asarray(B), lower=lower, leaf=128))


@pytest.mark.parametrize("n", [50, 600])
def test_cho_solve_blocked_matches_jax(n):
    L = np.linalg.cholesky(_spd(n, np.float64, seed=5))
    B = np.random.default_rng(6).standard_normal((n, 2))
    for b in (B, B[:, 0]):
        X = blocked.cho_solve_blocked(torch.tensor(L), torch.tensor(b), leaf=128)
        _close64(X, jblk.cho_solve_blocked(jnp.asarray(L), jnp.asarray(b), leaf=128))


def test_solve_r_matches_jax():
    L = np.linalg.cholesky(_spd(600, np.float64, seed=3))
    B = np.random.default_rng(4).standard_normal((3, 600))
    _close64(blocked._solve_r(torch.tensor(L), torch.tensor(B), 128),
             jblk._solve_r(jnp.asarray(L), jnp.asarray(B), 128))


def test_cho_solve_blocked_is_differentiable():
    """Built by concatenation, not in place: autograd reaches L and B."""
    L = torch.linalg.cholesky(torch.tensor(_spd(300, np.float64, seed=9))).requires_grad_(True)
    B = torch.ones((300, 2), dtype=torch.float64, requires_grad=True)
    blocked.cho_solve_blocked(L, B, leaf=128).sum().backward()
    X = torch.cholesky_solve(B.detach(), L.detach())
    gB = torch.cholesky_solve(torch.ones_like(X), L.detach())
    _close64(B.grad, gB)
    assert torch.isfinite(L.grad).all()


def test_block_tree_matches_jax():
    """tests/test_ops.py:579-590's contract: the assembled factor, and the
    last leaf whose [-1, -1] is the factor's."""
    A = _spd(1536, np.float64, seed=13)
    b = blocked.cholesky_blocked_blocks(torch.tensor(A), leaf=256)
    jb = jblk.cholesky_blocked_blocks(jnp.asarray(A), leaf=256)
    L = blocked.assemble_blocks(b)
    Lj = np.tril(np.asarray(jblk.assemble_blocks(jb)))
    _close64(L, Lj)
    _close64(blocked.assemble_blocks_concat(b), Lj)
    _close64(blocked.assemble_blocks_dus(b), Lj)
    ll, jll = blocked.last_leaf(b), jblk.last_leaf(jb)
    assert ll.shape == jll.shape and ll.shape[0] <= 256
    assert float(ll[-1, -1]) == float(L[-1, -1])
    _close64(np.tril(ll.numpy()), np.tril(np.asarray(jll)))
    A[5, 5] = -1e3  # a failed pivot reaches the last leaf
    failed = blocked.cholesky_blocked_blocks(torch.tensor(A), leaf=256)
    assert not torch.isfinite(blocked.last_leaf(failed)[-1, -1])


@pytest.mark.parametrize("n,panel", [(700, 512), (1536, 512), (1024, 1024)])
def test_cholesky_rightlooking_matches_jax(n, panel):
    A = _spd(n, np.float64, seed=11)
    L = blocked.cholesky_rightlooking(torch.tensor(A), panel=panel)
    _close64(L, np.tril(np.asarray(jblk.cholesky_rightlooking(jnp.asarray(A), panel=panel))))


@pytest.mark.parametrize("n", [200, 300, 1024])
def test_cholesky_blocked_v2_matches_jax(n):
    A = _spd(n, np.float64, seed=12)
    L = blocked.cholesky_blocked_v2(torch.tensor(A))
    _close64(np.tril(L.numpy()), np.tril(np.asarray(jblk.cholesky_blocked_v2(jnp.asarray(A)))))


@pytest.mark.parametrize("lower", [True, False])
def test_solve_triangular_blocked_v2_matches_jax(lower):
    L = np.linalg.cholesky(_spd(700, np.float64, seed=13))
    T = L if lower else L.T.copy()
    B = np.random.default_rng(14).standard_normal((700, 3))
    X = blocked.solve_triangular_blocked_v2(torch.tensor(T), torch.tensor(B), lower=lower)
    _close64(X, jblk.solve_triangular_blocked_v2(jnp.asarray(T), jnp.asarray(B), lower=lower))
