"""K12 leaf_chol's, K13 leaf_chol_wi's and K14 tri_inv_leaf's CUDA source
(gpr_tpu_torch/csrc/leaf.cu, with tri_inv.cuh) run on the CPU:
compiled by the host's g++ against tests/cuda_emu/emu.h, a shim that runs
every thread as a fiber and the CTAs of the kernel's thread-block cluster
together (s / 64 of them: 4 at s = 256, 8 at 512), each with its own shared
memory, with the cluster barrier in phases and cp.async as plain copies, so
that the kernel's block-row ownership, its strided reads and writes, the
tiles' way through the workspace, its barriers and its float32 rounding are
exercised where no CUDA compiler exists.  It says nothing of speed.

The same numpy inputs (seeded, symmetric) go through the emulated kernel, the
port's plain version and JAX's leaf_cholesky in interpret mode.  Tolerances:
1e-5 of the largest entry against both (float32 sums in other orders: the
kernel by 32-wide blocks, the plain version by 64-wide ones, JAX's by
256-wide ones; the card test's gate, tests/test_torch_cuda.py) and ||L L^T -
A|| / ||A|| < 1e-5 (Frobenius, float64 arithmetic on the float32 factor);
an exact-zero strict upper.  NaN above the diagonal leaves the factor
bit-identical (only the lower triangle is read), the factor in place over a
strided A is the same factor, and a failed pivot poisons its row, every
later one and L[-1, -1].

K14 (one launch of a persistent grid: items by ticket, 64-wide diagonal
blocks, then per doubling level 64x64 tiles of T = C inv(A) and W_CA =
-inv(D) T in pieces of 32 to 128 terms, whose partials each consumer adds as
it stages them and the tile's last piece adds into W).  The emulator runs
the CTAs one after another, so one CTA takes every item in ticket order and
emu.h's flag_wait aborts at once on a wait that order does not meet; with
EMU_SMS=3 the other CTAs find no item left, and the last of them resets the
flags.  leaf_main.cpp runs each launch twice on one set of flags and fails
unless they come back zero, the two W are bit-identical and nothing is
written past the scratch (as large as gpr_tri_inv_leaf_scratch says) or the
flags (as many as gpr_tri_inv_leaf_flags says).  At s = 256 and 512, on a seeded float32 factor: W L - I within 1e-4
in the max norm and W within 1e-5 of the largest entry of the port's plain W
and JAX's tri_inv_leaf(interpret=True) (float32 sums in other orders: the
kernel by 32-wide blocks and 64x64 tiles in 32- to 128-term pieces, the
plain version by 64-wide blocks, JAX's by 256-wide ones); an exact-zero
strict upper; NaN above the diagonal, a strided L and three CTAs leave W
bit-identical; a zero or NaN pivot gives a non-finite W.

K13 (K12's cluster factor, then K14's launch on it) at the same s: L
bit-identical to K12's (the same kernel) and W bit-identical to K14 of that
L (the same launch), W L - I within 1e-4 in the max norm (as
tests/test_ops.py:457-499 holds JAX's kernel) and W within 1e-5 of the
largest entry of the port's plain W and JAX's
leaf_cholesky_wi(interpret=True), L against JAX's at K12's 1e-5; exact-zero
strict uppers; NaN above the diagonal leaves L and W bit-identical; in place
over a strided buffer the same L and W; a failed pivot gives NaN at
L[-1, -1] and a non-finite W, as JAX's kernel does.
"""

import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_leaf as jleaf
from gpr_tpu_torch.ops import leaf

from cuda_emu_host import build


@pytest.fixture(scope="module")
def leaf_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("leaf"), "leaf.cu", "leaf_main.cpp")


def _run(exe, A, lda=None, inplace=False, wi=False):
    """K12 (with wi, K13: L and W) of the (s, s) leaf A, placed in an (s,
    lda) buffer whose other entries are NaN."""
    s = A.shape[0]
    lda = lda or s
    buf = np.full((s, lda), np.nan, np.float32)
    buf[:, :s] = A
    d = exe.parent
    buf.tofile(d / "A.bin")
    args = [str(exe), str(s), str(lda), str(int(inplace)), str(d / "A.bin"), str(d / "L.bin")]
    r = subprocess.run(args + ([str(d / "W.bin")] if wi else []), check=True, capture_output=True, text=True)
    assert r.stdout.split() == ["clusters", "1"]  # the shim places any cluster
    L = np.fromfile(d / "L.bin", np.float32).reshape(s, s)
    return (L, np.fromfile(d / "W.bin", np.float32).reshape(s, s)) if wi else L


def _run_inv(exe, L, ldl=None, ctas=1):
    """K14 of the (s, s) L, placed in an (s, ldl) buffer whose other entries
    are NaN, on `ctas` emulated CTAs (EMU_SMS)."""
    s = L.shape[0]
    ldl = ldl or s
    buf = np.full((s, ldl), np.nan, np.float32)
    buf[:, :s] = L
    d = exe.parent
    buf.tofile(d / "L.bin")
    r = subprocess.run([str(exe), "inv", str(s), str(ldl), str(d / "L.bin"), str(d / "W.bin")], check=True,
                       capture_output=True, text=True, env={**os.environ, "EMU_SMS": str(ctas)})
    assert r.stdout.split()[0] == "scratch"
    return np.fromfile(d / "W.bin", np.float32).reshape(s, s)


def _factor(s, seed):
    # a float32 factor of chip_smoke.py phase 18's leaf
    return np.linalg.cholesky(_spd(s, seed).astype(np.float64)).astype(np.float32)


def _spd(n, seed):
    # chip_smoke.py phase 18's leaf, G G^T / n + I
    G = np.random.default_rng(seed).standard_normal((n, n))
    return (G @ G.T / n + np.eye(n)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _nan_upper(A):
    return np.tril(A) + np.triu(np.full_like(A, np.nan), 1)


@pytest.mark.parametrize("s", [256, 512])
def test_leaf_source_matches_plain_and_jax(leaf_binary, s):
    A = _spd(s, seed=s)
    L = _run(leaf_binary, A)
    assert np.all(np.triu(L, 1) == 0)
    assert _rel(L, leaf.leaf_cholesky_reference(torch.tensor(A)).numpy()) <= 1e-5
    assert _rel(L, np.asarray(jleaf.leaf_cholesky(jnp.asarray(_nan_upper(A)), interpret=True))) <= 1e-5
    L64 = L.astype(np.float64)
    assert np.linalg.norm(L64 @ L64.T - A) / np.linalg.norm(A) < 1e-5
    assert np.array_equal(_run(leaf_binary, _nan_upper(A)), L)  # the upper triangle is never read


@pytest.mark.parametrize("s,lda", [(256, 300), (512, 520)])
def test_leaf_source_strided_and_in_place(leaf_binary, s, lda):
    A = _nan_upper(_spd(s, seed=s + 1))
    L = _run(leaf_binary, A)
    assert np.array_equal(_run(leaf_binary, A, lda=lda), L)
    assert np.array_equal(_run(leaf_binary, A, lda=lda, inplace=True), L)


@pytest.mark.parametrize("s,where", [(256, 0), (256, 100), (512, 31), (512, 32), (512, 511)])
def test_leaf_source_failed_pivot(leaf_binary, s, where):
    A = _spd(s, seed=9)
    A[where, where] = -1.0
    L = _run(leaf_binary, A)
    rows_ok = np.isfinite(L).all(axis=1)
    assert rows_ok[:where].all() and not rows_ok[where:].any()
    assert np.isnan(L[-1, -1]) and np.all(np.triu(L, 1) == 0)
    Lj = np.asarray(jleaf.leaf_cholesky(jnp.asarray(A), interpret=True))
    assert np.isnan(Lj[-1, -1])  # JAX's kernel is poisoned too
    e = where // leaf.BLOCK * leaf.BLOCK  # the plain version's 64-block fails whole
    if e:
        assert _rel(L[:e], leaf.leaf_cholesky_reference(torch.tensor(A)).numpy()[:e]) <= 1e-5


@pytest.mark.parametrize("s", [256, 512])
def test_leaf_wi_source_matches_plain_and_jax(leaf_binary, s):
    A = _spd(s, seed=s + 2)
    L, W = _run(leaf_binary, A, wi=True)
    assert np.array_equal(L, _run(leaf_binary, A))  # K13's factor is K12's kernel
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(W, 1) == 0)
    assert np.abs(W.astype(np.float64) @ L - np.eye(s)).max() < 1e-4
    Lr, Wr = leaf.leaf_cholesky_wi_reference(torch.tensor(A))
    assert _rel(L, Lr.numpy()) <= 1e-5 and _rel(W, Wr.numpy()) <= 1e-5
    Lj, Wj = (np.asarray(M) for M in jleaf.leaf_cholesky_wi(jnp.asarray(_nan_upper(A)), interpret=True))
    assert _rel(L, Lj) <= 1e-5 and _rel(W, Wj) <= 1e-5
    Ln, Wn = _run(leaf_binary, _nan_upper(A), wi=True)  # the upper triangle is never read
    assert np.array_equal(Ln, L) and np.array_equal(Wn, W)


@pytest.mark.parametrize("s,lda", [(256, 300), (512, 520)])
def test_leaf_wi_source_strided_and_in_place(leaf_binary, s, lda):
    A = _nan_upper(_spd(s, seed=s + 3))
    L, W = _run(leaf_binary, A, wi=True)
    for inplace in (False, True):
        Ls, Ws = _run(leaf_binary, A, lda=lda, inplace=inplace, wi=True)
        assert np.array_equal(Ls, L) and np.array_equal(Ws, W)


@pytest.mark.parametrize("s,where", [(256, 100), (512, 31), (512, 511)])
def test_leaf_wi_source_failed_pivot(leaf_binary, s, where):
    A = _spd(s, seed=10)
    A[where, where] = -1.0
    L, W = _run(leaf_binary, A, wi=True)
    assert np.isnan(L[-1, -1]) and not np.isfinite(W).all()
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(W, 1) == 0)
    Lj, Wj = jleaf.leaf_cholesky_wi(jnp.asarray(A), interpret=True)
    assert np.isnan(np.asarray(Lj)[-1, -1]) and not np.isfinite(np.asarray(Wj)).all()  # JAX's kernel too


@pytest.mark.parametrize("s", [256, 512])
def test_tri_inv_source_matches_plain_and_jax(leaf_binary, s):
    L = _factor(s, seed=s + 4)
    W = _run_inv(leaf_binary, L)
    assert np.all(np.triu(W, 1) == 0)
    assert np.abs(W.astype(np.float64) @ L - np.eye(s)).max() <= 1e-4
    assert _rel(W, leaf.tri_inv_leaf_reference(torch.tensor(L)).numpy()) <= 1e-5
    assert _rel(W, np.asarray(jleaf.tri_inv_leaf(jnp.asarray(_nan_upper(L)), interpret=True))) <= 1e-5
    assert np.array_equal(_run_inv(leaf_binary, _nan_upper(L)), W)  # the upper triangle is never read


@pytest.mark.parametrize("s,ldl", [(256, 300), (512, 520)])
def test_tri_inv_source_strided_and_three_ctas(leaf_binary, s, ldl):
    L = _nan_upper(_factor(s, seed=s + 5))
    W = _run_inv(leaf_binary, L)
    assert np.array_equal(_run_inv(leaf_binary, L, ldl=ldl), W)
    assert np.array_equal(_run_inv(leaf_binary, L, ctas=3), W)


@pytest.mark.parametrize("s,where,pivot", [(256, 0, 0.0), (256, 100, np.nan), (512, 63, 0.0),
                                           (512, 511, np.nan)])
def test_tri_inv_source_failed_pivot(leaf_binary, s, where, pivot):
    L = _factor(s, seed=11)
    L[where, where] = pivot
    W = _run_inv(leaf_binary, L)
    assert not np.isfinite(W).all() and np.all(np.triu(W, 1) == 0)


@pytest.mark.parametrize("s", [256, 512])
def test_leaf_wi_source_w_is_tri_inv_of_its_l(leaf_binary, s):
    L, W = _run(leaf_binary, _nan_upper(_spd(s, seed=s + 6)), wi=True)
    assert np.array_equal(_run_inv(leaf_binary, L), W)  # K13's inverse is K14's launch
