"""K11 diag_tri_inv's CUDA source (gpr_tpu_torch/csrc/solve.cu) run on the
CPU: compiled by the host's g++ against tests/cuda_emu/emu.h, a shim that
runs every thread of a block as a fiber and switches at the barriers and
shuffles, so the kernel's own index arithmetic and float32 rounding are
exercised where no CUDA compiler exists.  It says nothing of speed.

The same numpy inputs go through the emulated kernel, the port's plain
version, JAX's Pallas kernel in interpret mode and a float64 inverse.
Tolerances: 1e-4 relative against the plain version (the card test's,
tests/test_torch_cuda.py; float32 sums in other orders), 1e-5 of the largest
entry against JAX's kernel and W L = I to 2e-5 (tests/test_torch_solve.py's),
an exact-zero strict upper, NaN and junk above the diagonal ignored, and a
NaN pivot making its tile, and only it, non-finite; on a tile of cond ~1e4
the error against float64 within 3x the plain version's.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_solve as jps
from gpr_tpu_torch.ops import solve as ts

from cuda_emu_host import build


@pytest.fixture(scope="module")
def k11_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("k11"), "solve.cu", "k11_main.cpp")


def _run(exe, L, bs):
    n = L.shape[0]
    d = exe.parent
    np.ascontiguousarray(L, np.float32).tofile(d / "L.bin")
    subprocess.run([str(exe), str(n), str(bs), str(d / "L.bin"), str(d / "W.bin")], check=True)
    return np.fromfile(d / "W.bin", np.float32).reshape(n // bs, bs, bs)


def _factor(n, seed):
    # tests/test_ops.py:630-634's system
    X = np.random.default_rng(seed).standard_normal((n, 64)).astype(np.float32)
    return np.linalg.cholesky(X @ X.T / 64 + 4.0 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n,bs", [(48, 16), (144, 48), (1024, 256), (1024, 512)])
def test_k11_source_inverts_by_blocks(k11_binary, n, bs):
    Lh = _factor(n, seed=bs)
    Ln = Lh + np.triu(np.full((n, n), np.nan, np.float32), 1)  # never read
    W = _run(k11_binary, Ln, bs)
    assert np.all(np.triu(W, 1) == 0)
    assert _rel(W, ts.diag_tri_inv_reference(torch.tensor(Lh), bs).numpy()) <= 1e-4
    for i in range(n // bs):
        blk = Lh[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs]
        np.testing.assert_allclose(W[i] @ blk, np.eye(bs, dtype=np.float32), atol=2e-5)
    if bs >= 256:
        junk = Lh + np.triu(np.random.default_rng(1).standard_normal((n, n)).astype(np.float32), 1)
        Wj = np.asarray(jps._diag_block_inverses_pallas(jnp.asarray(junk), bs, interpret=True))
        assert _rel(W, Wj) < 1e-5


@pytest.mark.parametrize("bs", [48, 512])
def test_k11_source_nan_pivot(k11_binary, bs):
    Lh = _factor(3 * bs, seed=7)
    for p in sorted({0, 31, 32, 511, bs - 1} & set(range(bs))):
        bad = Lh.copy()
        bad[bs + p, bs + p] = np.nan
        W = _run(k11_binary, bad, bs)
        assert [bool(np.isfinite(W[i]).all()) for i in range(3)] == [True, False, True], p


@pytest.mark.parametrize("bs", [48, 512])
def test_k11_source_precision(k11_binary, bs):
    # a factor tile of cond ~1e4 (tests/test_torch_solve.py's): the blocked
    # inverse's error against float64 within 3x the plain substitution's
    rng = np.random.default_rng(24)
    Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
    Lh = np.linalg.cholesky((Q * np.logspace(0, -8, bs)) @ Q.T + 1e-12 * np.eye(bs)).astype(np.float32)
    truth = np.linalg.inv(Lh.astype(np.float64))
    err = _rel(_run(k11_binary, Lh, bs)[0], truth)
    err_plain = _rel(ts.diag_tri_inv_reference(torch.tensor(Lh), bs)[0], truth)
    assert err <= 3 * err_plain, (err, err_plain, err / err_plain)
