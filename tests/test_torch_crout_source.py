"""K7 crout_chol's and K8 crout_chol_wi's CUDA source (gpr_tpu_torch/csrc/
crout.cu, with crout.cuh's blocked factor on chol.cuh's warp pieces) run on
the CPU: compiled by the host's g++ against
tests/cuda_emu/emu.h, a shim that runs every thread of a block as a fiber and
switches at the barriers and shuffles, so that the kernel's index arithmetic,
its identity padding to a multiple of 32, its barriers and its float32
rounding are exercised where no CUDA compiler exists.  It says nothing of
speed.

The same numpy inputs (seeded SPD tiles G G^T + b I) go through the emulated
kernel, the port's plain version and JAX's Pallas kernel in interpret mode.
Tolerances: 1e-5 of the largest entry against both (the card test's,
tests/test_torch_cuda.py; JAX's kernel and the plain version step one column
at a time, the kernel by 32-wide blocks, so the float32 sums differ in
order); an exact-zero strict upper; junk and NaN above the diagonal never
read; a failed pivot makes its tile's L[-1, -1] NaN and leaves the other
tiles bit-identical; in place (L written over A) and strided views (row
stride past b) give the same factor bit for bit.

K8 (tests/cuda_emu/crout_wi_main.cpp) on the same kinds of tiles at b = 1,
17, 33, 64, 96, 128: L gets 1e-5 of its largest entry and W 1e-4 relative
(the card test's tolerances; the kernel forms W by row solves on identity
rows beside the factor, the plain version and JAX by a substitution inside
the column sweep, so the float32 sums differ in order), both with exact-zero
strict uppers.  JAX's interpret-mode crout_chol_wi takes ~2 s at b = 17 and
~140 s at b = 128 here, so JAX is run at b = 1 and 17 only; the plain
version, held to JAX at every width by tests/test_torch_crout.py, takes the
rest.  A failed pivot makes its tile's L[-1, -1] and W[-1, -1] NaN and leaves
the other tiles bit-identical; in place and strided, L and W are the same
bit for bit and nothing past a tile is written.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_batched as pb
from gpr_tpu_torch.ops import crout

from cuda_emu_host import build


@pytest.fixture(scope="module")
def k7_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("k7"), "crout.cu", "crout_main.cpp")


@pytest.fixture(scope="module")
def k8_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("k8"), "crout.cu", "crout_wi_main.cpp")


def _run(exe, A, ld=None, inplace=False):
    """The kernel on the (B, b, b) tiles A laid out with row stride ld."""
    B, b, _ = A.shape
    ld = b if ld is None else ld
    buf = np.full((B, b, ld), 4321.0, np.float32)
    buf[:, :, :b] = A
    d = exe.parent
    buf.tofile(d / "A.bin")
    subprocess.run([str(exe), str(B), str(b), str(ld), str(int(inplace)), str(d / "A.bin"), str(d / "L.bin")],
                   check=True, timeout=60)
    out = np.fromfile(d / "L.bin", np.float32).reshape(B, b, ld)
    if not inplace:
        assert np.all(out[:, :, b:] == 12345.0)  # nothing past the tile written
    elif ld > b:
        assert np.all(out[:, :, b:] == 4321.0)
    return out[:, :, :b]


def _spd(B, b, seed):
    G = np.random.default_rng(seed).standard_normal((B, b, b))
    return (G @ G.transpose(0, 2, 1) + b * np.eye(b)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("b", [1, 17, 32, 33, 96, 128])
def test_crout_source_matches_plain_and_jax(k7_binary, b):
    A = _spd(3, b, seed=b)
    junk = A + np.triu(np.random.default_rng(1).standard_normal((3, b, b)).astype(np.float32), 1)
    junk[1][np.triu_indices(b, 1)] = np.nan
    L = _run(k7_binary, junk)
    assert np.all(np.triu(L, 1) == 0) and np.isfinite(L).all()
    assert _rel(L, crout.crout_chol_reference(torch.tensor(A)).numpy()) <= 1e-5
    assert _rel(L, np.asarray(pb.crout_chol(jnp.asarray(A), interpret=True))) <= 1e-5


@pytest.mark.parametrize("b,p", [(33, 0), (33, 32), (96, 40), (128, 127)])
def test_crout_source_failed_pivot(k7_binary, b, p):
    A = _spd(3, b, seed=7)
    L = _run(k7_binary, A)
    bad = A.copy()
    bad[1, p, p] = -1.0
    Lb = _run(k7_binary, bad)
    assert np.isnan(Lb[1, -1, -1]) and np.isfinite(Lb[1, :p]).all()
    assert np.array_equal(Lb[[0, 2]], L[[0, 2]])


@pytest.mark.parametrize("b,ld", [(64, 64), (45, 80)])
def test_crout_source_in_place_and_strided(k7_binary, b, ld):
    A = _spd(2, b, seed=3)
    L = _run(k7_binary, A)
    assert np.array_equal(_run(k7_binary, A, ld=ld, inplace=True), L)
    assert np.array_equal(_run(k7_binary, A, ld=ld + 3), L)


def _run_wi(exe, A, ld=None, inplace=False):
    """K8 on the (B, b, b) tiles A laid out with row stride ld: (L, W)."""
    B, b, _ = A.shape
    ld = b if ld is None else ld
    buf = np.full((B, b, ld), 4321.0, np.float32)
    buf[:, :, :b] = A
    d = exe.parent
    buf.tofile(d / "A.bin")
    subprocess.run([str(exe), str(B), str(b), str(ld), str(int(inplace)), str(d / "A.bin"), str(d / "L.bin"),
                    str(d / "W.bin")], check=True, timeout=60)
    L = np.fromfile(d / "L.bin", np.float32).reshape(B, b, ld)
    W = np.fromfile(d / "W.bin", np.float32).reshape(B, b, ld)
    assert np.all(W[:, :, b:] == 12345.0)  # nothing past the tile written
    assert np.all(L[:, :, b:] == (4321.0 if inplace else 12345.0))
    return L[:, :, :b], W[:, :, :b]


@pytest.mark.parametrize("b", [1, 17, 33, 64, 96, 128])
def test_crout_wi_source_matches_plain_and_jax(k8_binary, b):
    A = _spd(3, b, seed=b + 1)
    junk = A + np.triu(np.random.default_rng(2).standard_normal((3, b, b)).astype(np.float32), 1)
    junk[1][np.triu_indices(b, 1)] = np.nan
    L, W = _run_wi(k8_binary, junk)
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(W, 1) == 0)
    assert np.isfinite(L).all() and np.isfinite(W).all()
    R, RW = (t.numpy() for t in crout.crout_chol_wi_reference(torch.tensor(A)))
    assert _rel(L, R) <= 1e-5 and _rel(W, RW) <= 1e-4
    if b <= 17:
        Lj, Wj = (np.asarray(t) for t in pb.crout_chol_wi(jnp.asarray(A), interpret=True))
        assert _rel(L, Lj) <= 1e-5 and _rel(W, Wj) <= 1e-4


@pytest.mark.parametrize("b,p", [(17, 16), (33, 0), (64, 40), (128, 127)])
def test_crout_wi_source_failed_pivot(k8_binary, b, p):
    A = _spd(3, b, seed=8)
    L, W = _run_wi(k8_binary, A)
    bad = A.copy()
    bad[1, p, p] = -1.0
    Lb, Wb = _run_wi(k8_binary, bad)
    assert np.isnan(Lb[1, -1, -1]) and np.isnan(Wb[1, -1, -1]) and np.isfinite(Lb[1, :p]).all()
    assert np.array_equal(Lb[[0, 2]], L[[0, 2]]) and np.array_equal(Wb[[0, 2]], W[[0, 2]])


@pytest.mark.parametrize("b,ld", [(64, 64), (45, 80)])
def test_crout_wi_source_in_place_and_strided(k8_binary, b, ld):
    A = _spd(2, b, seed=4)
    L, W = _run_wi(k8_binary, A)
    Li, Wi = _run_wi(k8_binary, A, ld=ld, inplace=True)
    Ls, Ws = _run_wi(k8_binary, A, ld=ld + 3)
    assert np.array_equal(Li, L) and np.array_equal(Wi, W)
    assert np.array_equal(Ls, L) and np.array_equal(Ws, W)
