"""The port's single-tile Cholesky (gpr_tpu_torch.ops.chol: the plain versions
of K19 tile_chol and K20 tile_chol_strips, and the leaf dispatcher) against
gpr_tpu.ops.pallas_chol on the CPU, where the JAX package runs its Pallas
kernels in interpret mode, as tests/test_ops.py:306-357 does.

The same numpy inputs (seeded) go through both packages.  Tolerances,
relative to the largest entry: float32 1e-5, the gate tests/test_ops.py:318
puts on JAX's kernel (the same steps; JAX's row 14 scales by rsqrt, the port
by 1 / sqrt, and the sums run in another order); float64 1e-10.  Row 15 is
compared on symmetric input only: JAX's strip kernel also reads the strict
lower triangle inside each diagonal strip block, the port's only the upper
triangle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_chol as jchol
from gpr_tpu_torch.ops import chol

TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _spd(n, dtype, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return (M @ M.T + n * np.eye(n)).astype(dtype)


def _with_lower(A, lower):
    """A's upper triangle (diagonal included) over ``lower``'s strict lower."""
    return np.triu(A) + np.tril(lower, -1)


def _jax(kernel, A, sw=None):
    if kernel == "v1":
        return np.asarray(jchol.cholesky_pallas(jnp.asarray(A), interpret=True))
    return np.asarray(jchol.cholesky_pallas_v2(jnp.asarray(A), sw=sw, interpret=True))


def _port(kernel, A, sw=None):
    if kernel == "v1":
        return chol.cholesky_tile(torch.tensor(A)).numpy()
    return chol.cholesky_tile_v2(torch.tensor(A), sw=sw).numpy()


KERNELS = [("v1", None), ("v2", 8), ("v2", 16)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("kernel,sw", KERNELS)
def test_tile_kernels_match_jax(kernel, sw, n, dtype):
    A = _spd(n, dtype, seed=n)
    L, Lj = _port(kernel, A, sw), _jax(kernel, A, sw)
    assert L.dtype == dtype and np.all(np.triu(L, 1) == 0)
    assert _rel(L, Lj) < TOL[dtype]
    assert _rel(L, np.linalg.cholesky(A.astype(np.float64))) < 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("junk", ["nan", "other"])
def test_row14_reads_only_the_upper_triangle(junk, dtype):
    A = _spd(64, dtype, seed=5)
    other = np.full_like(A, np.nan) if junk == "nan" else _spd(64, dtype, seed=6)
    Ab = _with_lower(A, other)
    L, Lj = _port("v1", Ab), _jax("v1", Ab)
    assert np.array_equal(L, _port("v1", A))  # bit-identical to the clean run
    assert np.all(np.isfinite(L)) and _rel(L, Lj) < TOL[dtype]
    if junk == "other":  # not the factor of the lower triangle
        low = np.tril(Ab) + np.tril(Ab, -1).T
        assert _rel(L, np.linalg.cholesky(low.astype(np.float64))) > 0.1


@pytest.mark.parametrize("sw", [8, 16])
def test_row15_port_reads_only_the_upper_triangle(sw):
    A = _spd(64, np.float32, seed=7)
    clean = _port("v2", A, sw)
    for lower in (np.full_like(A, np.nan), _spd(64, np.float32, seed=8)):
        assert np.array_equal(_port("v2", _with_lower(A, lower), sw), clean)


@pytest.mark.parametrize("where", [5, 37])
@pytest.mark.parametrize("kernel,sw", KERNELS[:2])
def test_failed_pivot_poisons_the_rows_from_it(kernel, sw, where):
    A = _spd(64, np.float32, seed=9)
    A[where, where] = -1.0
    L, Lj = _port(kernel, A, sw), _jax(kernel, A, sw)
    rows_ok = np.isfinite(L).all(axis=1)
    assert np.array_equal(rows_ok, np.isfinite(Lj).all(axis=1))
    assert rows_ok[:where].all() and not rows_ok[where:].any()
    assert np.isnan(L[-1, -1]) and np.isnan(Lj[-1, -1])
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(Lj, 1) == 0)
    np.testing.assert_allclose(L[:where], Lj[:where], rtol=0, atol=1e-5 * np.abs(Lj[:where]).max())


@pytest.mark.parametrize("n,sw", [(100, 8), (200, 16), (36, 16)])
def test_strip_width_must_divide_n(n, sw):
    with pytest.raises(ValueError):
        jchol.cholesky_pallas_v2(jnp.eye(n, dtype=jnp.float32), sw=sw, interpret=True)
    with pytest.raises(ValueError):
        chol.cholesky_tile_v2(torch.eye(n), sw=sw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["spd", "asymmetric", "not_pd"])
def test_leaf_cholesky_matches_jax(case, dtype):
    A = _spd(48, dtype, seed=11)
    if case == "asymmetric":  # jnp.linalg.cholesky factors (A + A^T) / 2
        A = A + np.tril(np.random.default_rng(12).standard_normal((48, 48)), -1).astype(dtype)
    elif case == "not_pd":
        A[20, 20] = -1.0
    Lj = np.asarray(jchol.leaf_cholesky(jnp.asarray(A)))
    L = chol.leaf_cholesky(torch.tensor(A)).numpy()
    assert L.dtype == dtype and np.array_equal(np.isnan(L), np.isnan(Lj))
    if case == "not_pd":
        assert np.isnan(L[np.tril_indices(48)]).all() and np.all(np.triu(L, 1) == 0)
        return
    assert _rel(L, Lj) < TOL[dtype]
    if case == "asymmetric":  # not the factor of the lower triangle alone
        low = torch.linalg.cholesky(torch.tensor(A)).numpy()
        assert _rel(L, low) > 1e-3

