"""K7's and K8's plain versions (gpr_tpu_torch.ops.crout.crout_chol_reference,
crout_chol_wi_reference) against the JAX package's Pallas Crout sweeps
(gpr_tpu.ops.pallas_batched.crout_chol, crout_chol_wi) in interpret mode,
their contracts, and the wrappers' refusals.

Both run the W-free sweep in float32; JAX fuses pivot pairs (step2,
pallas_batched.py:119-173) where the plain version steps one column at a
time, so they round differently: 1e-5 of the largest |L| entry.  A
non-positive pivot leaves its tile's L[-1, -1] non-finite in both (-inf
from 1 / max(piv, 0) = inf through the trailing updates); the kernel, whose
pivot scale is 1.0f / sqrtf(piv), makes it NaN (tests/test_torch_cuda.py).  With W, both
step the same forward substitution in other groupings: W agrees to 1e-5 of
its largest entry, and W L = I to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_batched as pb
from gpr_tpu_torch.ops import _cuda, crout


def _spd(B, b, seed):
    G = np.random.default_rng(seed).standard_normal((B, b, b))
    return (G @ G.transpose(0, 2, 1) + b * np.eye(b)).astype(np.float32)


@pytest.mark.parametrize("b", [32, 33])
def test_matches_pallas_interpret(b):
    A = _spd(4, b, b)
    A[2, 3, 3] = -1.0  # one member that is not positive definite
    Lj = np.asarray(pb.crout_chol(jnp.asarray(A), interpret=True))
    _cuda.reset_launch_counts()
    Lt = crout.crout_chol(torch.tensor(A)).numpy()
    assert _cuda.launch_counts()["crout_chol"] == 0  # a CPU tensor runs the plain version
    ok = [0, 1, 3]
    scale = np.abs(Lj[ok]).max()
    np.testing.assert_allclose(Lt[ok], Lj[ok], rtol=0, atol=1e-5 * scale)
    assert not np.isfinite(Lj[2, -1, -1]) and not np.isfinite(Lt[2, -1, -1])
    # the columns before the failed pivot are factored as in an SPD tile
    np.testing.assert_allclose(Lt[2, :, :3], Lj[2, :, :3], rtol=0, atol=1e-5 * scale)
    ref = np.linalg.cholesky(A[ok].astype(np.float64))
    assert np.abs(Lt[ok] - ref).max() <= 1e-5 * scale
    assert not np.triu(Lt, 1).any()


def test_reads_the_lower_triangle_only():
    A = _spd(3, 32, 5)
    junk = A.copy()
    junk[:, np.triu_indices(32, 1)[0], np.triu_indices(32, 1)[1]] = np.nan
    L0 = crout.crout_chol(torch.tensor(A))
    L1 = crout.crout_chol(torch.tensor(junk))
    torch.testing.assert_close(L1, L0, rtol=0, atol=0)
    Lj = np.asarray(pb.crout_chol(jnp.asarray(np.where(np.isnan(junk), 777.0, junk)),
                                  interpret=True))
    np.testing.assert_allclose(L1.numpy(), Lj, rtol=0, atol=1e-5 * np.abs(Lj).max())


def test_in_place_on_the_diagonal_blocks_of_a_buffer():
    """The fleet factorization hands K7 strided views of its (B, n, n)
    buffer and writes L over them."""
    S = torch.tensor(np.stack([np.kron(np.eye(2), m) for m in _spd(2, 16, 7)]))  # (2, 32, 32)
    before = S.clone()
    D = S[:, 16:, 16:]
    out = crout.crout_chol(D, out=D)
    assert out.data_ptr() == D.data_ptr()
    torch.testing.assert_close(S[:, 16:, 16:], torch.linalg.cholesky(before[:, 16:, 16:]),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(S[:, :16], before[:, :16], rtol=0, atol=0)


def test_max_tile_matches_the_kernel_source():
    src = (_cuda.CSRC / "crout.cu").read_text()
    assert f"constexpr int kCroutMaxTile = {crout.MAX_TILE};" in src


def test_wrapper_refuses_what_the_kernel_does_not_take():
    A = torch.eye(8).expand(2, 8, 8).contiguous()
    with pytest.raises(ValueError):
        crout.crout_chol(A[0])  # not (B, b, b)
    with pytest.raises(ValueError):
        crout.crout_chol(torch.zeros((2, 8, 7)))  # not square
    with pytest.raises(ValueError):
        crout.crout_chol(torch.zeros((0, 8, 8)))  # empty
    with pytest.raises(ValueError):
        crout.crout_chol(A.transpose(0, 2))  # rows not contiguous
    with pytest.raises(ValueError):
        crout.crout_chol(A, out=torch.zeros((2, 8, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        crout.crout_chol(A.to("meta"))  # neither CPU nor CUDA


@pytest.mark.parametrize("b", [32, 33, 64])
def test_wi_matches_pallas_interpret(b):
    A = _spd(4, b, b + 1)
    A[2, 3, 3] = -1.0  # one member that is not positive definite
    junk = A.copy()
    junk[:, np.triu_indices(b, 1)[0], np.triu_indices(b, 1)[1]] = np.nan
    Lj, Wj = (np.asarray(v) for v in pb.crout_chol_wi(jnp.asarray(junk), interpret=True))
    _cuda.reset_launch_counts()
    Lt, Wt = (v.numpy() for v in crout.crout_chol_wi(torch.tensor(junk)))  # lower read only
    assert _cuda.launch_counts()["crout_chol_wi"] == 0
    ok = [0, 1, 3]
    np.testing.assert_allclose(Lt[ok], Lj[ok], rtol=0, atol=1e-5 * np.abs(Lj[ok]).max())
    np.testing.assert_allclose(Wt[ok], Wj[ok], rtol=0, atol=1e-5 * np.abs(Wj[ok]).max())
    ref = np.linalg.cholesky(A[ok].astype(np.float64))
    assert np.abs(Wt[ok] @ ref - np.eye(b)).max() <= 1e-5
    assert not np.isfinite(Lj[2, -1, -1]) and not np.isfinite(Lt[2, -1, -1])
    assert not np.isfinite(Wt[2, -1, -1])
    assert not np.triu(Lt, 1).any() and not np.triu(Wt, 1).any()


def test_wi_in_place_on_strided_views():
    S = torch.tensor(np.stack([np.kron(np.eye(2), m) for m in _spd(2, 16, 8)]))  # (2, 32, 32)
    before = S.clone()
    Wbuf = torch.full((2, 16, 20), 7.0, dtype=S.dtype)
    D, Wv = S[:, 16:, 16:], Wbuf[:, :, 2:18]
    L, W = crout.crout_chol_wi(D, L_out=D, W_out=Wv)
    assert L.data_ptr() == D.data_ptr() and W.data_ptr() == Wv.data_ptr()
    ref = torch.linalg.cholesky(before[:, 16:, 16:])
    torch.testing.assert_close(S[:, 16:, 16:], ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(Wv, torch.linalg.inv(ref), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(S[:, :16], before[:, :16], rtol=0, atol=0)
    assert bool((Wbuf[:, :, :2] == 7.0).all() and (Wbuf[:, :, 18:] == 7.0).all())


def test_wi_wrapper_refuses_what_the_kernel_does_not_take():
    A = torch.eye(8).expand(2, 8, 8).contiguous()
    with pytest.raises(ValueError):
        crout.crout_chol_wi(A[0])  # not (B, b, b)
    with pytest.raises(ValueError):
        crout.crout_chol_wi(A, W_out=A)  # W over A
    L = torch.empty_like(A)
    with pytest.raises(ValueError):
        crout.crout_chol_wi(A, L_out=L, W_out=L)  # W over L
    with pytest.raises(ValueError):
        crout.crout_chol_wi(A, W_out=torch.zeros((2, 8, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        crout.crout_chol_wi(A, L_out=torch.zeros((2, 8, 8)).transpose(1, 2))  # not row-major
    with pytest.raises(ValueError):
        crout.crout_chol_wi(A.to("meta"))  # neither CPU nor CUDA
