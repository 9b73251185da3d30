"""K19 tile_chol and K20 tile_chol_strips' CUDA source
(gpr_tpu_torch/csrc/chol.cu) run on the CPU: compiled by the host's g++
against tests/cuda_emu/emu.h, a shim that runs every thread as a fiber and the
8 CTAs of the kernel's thread-block cluster together, each with its own
shared memory, with the cluster barrier in phases, so that the kernel's
index arithmetic, its partial last block, its barriers, the panels' way
through the workspace and its float32 rounding are exercised where no CUDA
compiler exists.  It says nothing of speed.

The same numpy inputs (seeded, symmetric) go through the emulated kernel, the
port's plain version and JAX's cholesky_pallas / cholesky_pallas_v2 in
interpret mode.  Tolerances: 1e-5 of the largest entry against the plain
version (the card test's, tests/test_torch_cuda.py) and against JAX's kernel
(tests/test_torch_chol.py's), ||L L^T - A|| / ||A|| < 1e-5 (Frobenius,
float64 arithmetic on the float32 factor) and an exact-zero strict upper;
NaN below the diagonal leaves the factor bit-identical, and a failed pivot
poisons its row and every later one, as in JAX's kernels.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_chol as jchol
from gpr_tpu_torch.ops import chol

from cuda_emu_host import build


@pytest.fixture(scope="module")
def chol_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("chol"), "chol.cu", "chol_main.cpp")


def _run(exe, A, sw):
    n = A.shape[0]
    d = exe.parent
    np.ascontiguousarray(A, np.float32).tofile(d / "A.bin")
    subprocess.run([str(exe), str(n), str(sw), str(d / "A.bin"), str(d / "L.bin")], check=True)
    return np.fromfile(d / "L.bin", np.float32).reshape(n, n)


def _spd(n, seed):
    # chip_smoke.py phase 25's tile, G G^T / n + I
    G = np.random.default_rng(seed).standard_normal((n, n))
    return (G @ G.T / n + np.eye(n)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _plain(A, sw):
    if sw == 1:
        return chol.cholesky_tile_reference(torch.tensor(A)).numpy()
    return chol.cholesky_tile_v2_reference(torch.tensor(A), sw=sw).numpy()


def _jax(A, sw):
    if sw == 1:
        return np.asarray(jchol.cholesky_pallas(jnp.asarray(A), interpret=True))
    return np.asarray(jchol.cholesky_pallas_v2(jnp.asarray(A), sw=sw, interpret=True))


CASES = [(1, n) for n in (1, 32, 33, 200, 256)] + [(sw, n) for sw in (8, 16) for n in (64, 256)]


@pytest.mark.parametrize("sw,n", CASES)
def test_chol_source_matches_plain_and_jax(chol_binary, sw, n):
    A = _spd(n, seed=n + sw)
    L = _run(chol_binary, A, sw)
    assert np.all(np.triu(L, 1) == 0)
    assert _rel(L, _plain(A, sw)) <= 1e-5
    assert _rel(L, _jax(A, sw)) <= 1e-5
    L64 = L.astype(np.float64)
    assert np.linalg.norm(L64 @ L64.T - A) / np.linalg.norm(A) < 1e-5
    A_nan = np.triu(A) + np.tril(np.full_like(A, np.nan), -1)  # never read
    assert np.array_equal(_run(chol_binary, A_nan, sw), L)


@pytest.mark.parametrize("sw,n,where", [(1, 64, 0), (1, 64, 31), (1, 64, 32), (1, 200, 199), (8, 64, 37),
                                        (16, 64, 32)])
def test_chol_source_failed_pivot(chol_binary, sw, n, where):
    A = _spd(n, seed=9)
    A[where, where] = -1.0
    L, Lj = _run(chol_binary, A, sw), _jax(A, sw)
    rows_ok = np.isfinite(L).all(axis=1)
    assert rows_ok[:where].all() and not rows_ok[where:].any()
    assert np.array_equal(rows_ok, np.isfinite(Lj).all(axis=1))
    assert np.isnan(L[-1, -1]) and np.all(np.triu(L, 1) == 0)
    if where:
        assert _rel(L[:where], _plain(A, sw)[:where]) <= 1e-5
