"""K9 fleet_fused's CUDA source (gpr_tpu_torch/csrc/fleet.cu, with crout.cuh's
blocked factor-and-inverse on chol.cuh's warp pieces) run on the CPU:
compiled by the host's g++ against tests/cuda_emu/emu.h (every thread a
fiber, switched at barriers and shuffles; cp.async a plain copy) and driven
by tests/cuda_emu/fleet_main.cpp, so that the kernel's index arithmetic, its
barriers, its paired groups of shared P tiles (n > 704 at panel 64), its
forward substitution inside the panel steps and its float32 rounding are
exercised where no CUDA compiler exists.  It says nothing of speed.

The same numpy inputs (seeded SPD fleets G G^T + n I, member 1 failing in
its last panel, NaN above the diagonal) go through the emulated kernel and
the port's plain version (factor_solve_fused_reference), at n = 64, 128, 256
and every panel 16, 32, 64, 128 that divides them, q = 1, 4, 9 (9: two
backward passes of 8); at n = 768 (the paired groups); at panels 6 and 15
(no 16-byte chunks); and at q = 17 (the forward substitution as a pass of
its own, past the 16 right-hand sides it takes inside the panel steps).
Tolerances (the card test's, tests/test_torch_cuda.py): L 1e-5 and alpha
1e-4 relative to their largest
entry, W 1e-4; the kernel sums in other orders (32-wide blocks, W by row
solves).  L's strict upper is exactly 0 in every member; the failed member's
L[-1, -1] and alpha are NaN and the others finite and bit-identical to a run
without the failure.  JAX's Pallas kernel in interpret mode takes ~11 s at
n = 64, panel 16 and minutes at larger panels here, so it is run there only;
tests/test_torch_fleet_fused.py holds the plain version to it.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_batched as pb
from gpr_tpu_torch.ops import batched as fb

from cuda_emu_host import build


@pytest.fixture(scope="module")
def k9_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("k9"), "fleet.cu", "fleet_main.cpp")


def _run(exe, A, Y, p):
    B, n, _ = A.shape
    q = Y.shape[-1]
    d = exe.parent
    A.astype(np.float32).tofile(d / "A.bin")
    Y.astype(np.float32).tofile(d / "Y.bin")
    subprocess.run([str(exe), str(B), str(n), str(p), str(q)]
                   + [str(d / f) for f in ("A.bin", "Y.bin", "L.bin", "X.bin", "W.bin")], check=True, timeout=120)
    return (np.fromfile(d / "L.bin", np.float32).reshape(B, n, n),
            np.fromfile(d / "X.bin", np.float32).reshape(B, n, q),
            np.fromfile(d / "W.bin", np.float32).reshape(B, n // p, p, p))


def _fleet(B, n, q, seed):
    r = np.random.default_rng(seed)
    G = r.standard_normal((B, n, n))
    A = (G @ G.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    return A, r.standard_normal((B, n, q)).astype(np.float32)


def _junk(A):
    junk = A.copy()
    iu = np.triu_indices(A.shape[-1], 1)
    junk[:, iu[0], iu[1]] = np.nan
    return junk


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


CASES = [(64, 16, 1), (64, 32, 4), (64, 64, 9), (128, 16, 4), (128, 32, 9), (128, 64, 1), (128, 128, 4),
         (256, 16, 9), (256, 32, 1), (256, 64, 4), (256, 128, 9), (768, 64, 4), (90, 6, 2), (45, 15, 3),
         (64, 64, 17)]


@pytest.mark.parametrize("n,p,q", CASES)
def test_fleet_source_matches_plain(k9_binary, n, p, q):
    B = 2 if n > 256 else 3
    A, Y = _fleet(B, n, q, seed=n + p + q)
    bad = A.copy()
    bad[1, n - 5, n - 5] = -1e4  # member 1 fails in its last panel
    L, X, W = _run(k9_binary, _junk(bad), Y, p)
    R, RX, RW = (t.numpy() for t in fb.factor_solve_fused_reference(torch.tensor(A), torch.tensor(Y), p,
                                                                    return_winv=True))
    ok = [0] + list(range(2, B))
    assert _rel(L[ok], R[ok]) <= 1e-5 and _rel(X[ok], RX[ok]) <= 1e-4 and _rel(W[ok], RW[ok]) <= 1e-4
    assert np.all(np.triu(L, 1) == 0) and np.isfinite(L[ok]).all() and np.isfinite(X[ok]).all()
    assert np.isnan(L[1, -1, -1]) and np.isnan(X[1]).any()
    # the failure stays in its member
    L0, X0, W0 = _run(k9_binary, _junk(A), Y, p)
    assert np.array_equal(L[ok], L0[ok]) and np.array_equal(X[ok], X0[ok]) and np.array_equal(W[ok], W0[ok])
    assert _rel(L0[1], R[1]) <= 1e-5 and _rel(X0[1], RX[1]) <= 1e-4


def test_fleet_source_matches_jax_interpret(k9_binary):
    A, Y = _fleet(3, 64, 2, seed=5)
    L, X, _ = _run(k9_binary, _junk(A), Y, 16)
    Lj, Xj = (np.asarray(t) for t in pb.factor_solve_fused(jnp.asarray(A), jnp.asarray(Y), panel=16,
                                                            interpret=True))
    assert _rel(L, Lj) <= 1e-5 and _rel(X, Xj) <= 1e-4
