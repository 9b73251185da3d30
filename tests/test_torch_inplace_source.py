"""K17 panel_inplace's CUDA source (gpr_tpu_torch/csrc/panel.cu, with
chol.cuh) run on the CPU: compiled by the host's g++ against
tests/cuda_emu/emu.h, a shim that runs every thread as a fiber and the 8 CTAs
of the diagonal kernel's thread-block cluster together, each with its own
shared memory, with the cluster barrier in phases and cp.async as plain
copies, so that the diagonal tile's lower-triangle read, its factor and
inverse on the cluster, its write back into S, the rows kernel rewriting the
rows below in place and the float32 rounding are exercised where no CUDA
compiler exists.  It says nothing of speed.

The same numpy buffer S (seeded, SPD, NaN or 1234.0 in the strict upper of
the panel's diagonal tile) goes through the emulated kernel, the port's
plain version and JAX's panel_inplace in interpret mode, at n = 512 and 1024,
the first, the second and the last panel.  Tolerances: the panel within
1e-5 of its largest entry against both (float32 sums in other orders: the
kernel by 32-wide blocks and products with W, the plain version by
cholesky_ex and a triangular solve, JAX's by strips and products with its
inverse; the card test's gate, tests/test_torch_cuda.py); the diagonal tile's
strict upper exactly 0; the rest of S bit-identical to the input; NaN and
1234.0 above the diagonal give bit-identical outputs (only the lower triangle
is read).  A failed pivot makes the tile's last pivot NaN and leaves a NaN
in every row below it.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops import inplace_chol as jic
from gpr_tpu_torch.ops import inplace_chol as ic

from cuda_emu_host import build


@pytest.fixture(scope="module")
def inplace_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("inplace"), "panel.cu", "inplace_main.cpp")


def _run(exe, S, c0t):
    """K17 on a copy of the (n, n) buffer S at tile column c0t."""
    n = S.shape[0]
    d = exe.parent
    np.ascontiguousarray(S, np.float32).tofile(d / "S.bin")
    subprocess.run([str(exe), str(n), str(c0t), str(d / "S.bin"), str(d / "out.bin")], check=True)
    return np.fromfile(d / "out.bin", np.float32).reshape(n, n)


def _spd(n, seed):
    G = np.random.default_rng(seed).standard_normal((n, n))
    return (G @ G.T + n * np.eye(n)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _junk(A, c0t, value):
    S = A.copy()
    e = (c0t + 1) * 256
    tile = S[c0t * 256:e, c0t * 256:e]
    tile[np.triu_indices(256, 1)] = value
    return S


@pytest.mark.parametrize("n,c0t", [(512, 0), (512, 1), (1024, 0), (1024, 1), (1024, 3)])
def test_panel_inplace_source_matches_plain_and_jax(inplace_binary, n, c0t):
    A = _spd(n, seed=n + c0t)
    S = _junk(A, c0t, np.nan)
    out = _run(inplace_binary, S, c0t)
    e = (c0t + 1) * 256
    panel = np.s_[c0t * 256:, c0t * 256:e]
    assert np.all(np.triu(out[c0t * 256:e, c0t * 256:e], 1) == 0)
    rest = np.ones(S.shape, bool)
    rest[panel] = False
    assert np.array_equal(out[rest], S[rest], equal_nan=True)  # only the panel is rewritten
    ref = ic.panel_inplace_reference(torch.tensor(A), c0t).numpy()
    assert _rel(out[panel], ref[panel]) <= 1e-5
    out_j = np.asarray(jic.panel_inplace(jnp.asarray(S), c0t, interpret=True))
    assert _rel(out[panel], out_j[panel]) <= 1e-5
    assert np.array_equal(_run(inplace_binary, _junk(A, c0t, 1234.0), c0t)[panel], out[panel])


@pytest.mark.parametrize("n,c0t,where", [(512, 0, 40), (1024, 1, 255)])
def test_panel_inplace_source_failed_pivot(inplace_binary, n, c0t, where):
    S = _spd(n, seed=7)
    r = c0t * 256 + where
    S[r, r] = -1.0
    out = _run(inplace_binary, S, c0t)
    e = (c0t + 1) * 256
    assert np.isnan(out[e - 1, e - 1])
    assert not np.isfinite(out[e:, c0t * 256:e]).all(axis=1).any()
