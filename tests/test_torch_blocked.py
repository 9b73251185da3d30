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
