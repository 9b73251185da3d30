"""K10 narrow_subst's CUDA source (gpr_tpu_torch/csrc/solve.cu: one
persistent kernel a sweep, work items from a ticket counter, flags in device
memory) run on the CPU: compiled by the host's g++ against
tests/cuda_emu/emu.h, a shim that runs every thread of a block as a fiber and
switches at the barriers.  Its occupancy query answers one CTA, so one CTA
takes every item in ticket order; a wait that the order does not meet aborts
at once (emu.h's flags.cuh), so the test checks that each item waits only on
items handed out before it, and the sweep's index arithmetic and float32
rounding.  It says nothing of speed.  Each run has a timeout.

The same numpy inputs (tests/test_ops.py:630-634's system, junk above the
diagonal) go through both emulated sweeps and the port's plain version:
1e-5 of the largest entry (the card test's, tests/test_torch_cuda.py; both sum
128-term pieces in float32, in other orders).  A NaN in the strict lower
triangle of L makes the sweeps non-finite from its block row on.
"""

import subprocess

import numpy as np
import pytest
import torch

from gpr_tpu_torch.ops import solve

from cuda_emu_host import build


@pytest.fixture(scope="module")
def k10_binary(tmp_path_factory):
    return build(tmp_path_factory.mktemp("k10"), "solve.cu", "subst_main.cpp")


def _run(exe, L, W, B):
    n, q = B.shape
    bs = W.shape[1]
    d = exe.parent
    for a, name in ((L, "L"), (W, "W"), (B, "B")):
        np.ascontiguousarray(a, np.float32).tofile(d / f"{name}.bin")
    subprocess.run([str(exe), str(n), str(q), str(bs)] + [str(d / f"{x}.bin") for x in "LWBYX"],
                   check=True, timeout=60)
    return (np.fromfile(d / "Y.bin", np.float32).reshape(n, q),
            np.fromfile(d / "X.bin", np.float32).reshape(n, q))


def _system(n, q, bs, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 64)).astype(np.float32)
    Lh = np.linalg.cholesky(X @ X.T / 64 + 4.0 * np.eye(n, dtype=np.float32)).astype(np.float32)
    Lj = Lh + np.triu(rng.standard_normal((n, n)).astype(np.float32), 1)
    W = solve.diag_block_inverses(torch.tensor(Lh), bs, "xla").numpy()
    return Lh, Lj, W, rng.standard_normal((n, q)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("nb,bs", [(2, 128), (4, 128), (2, 512), (4, 256)])
@pytest.mark.parametrize("q", [1, 8, 16, 20])
def test_subst_source_sweeps_match_plain(k10_binary, nb, bs, q):
    n = nb * bs
    Lh, Lj, W, B = _system(n, q, bs, seed=n + q)
    Y, X = _run(k10_binary, Lj, W, B)
    Lt, Wt = torch.tensor(Lh), torch.tensor(W)
    assert _rel(Y, solve.subst_pass_reference(Lt, Wt, torch.tensor(B), True).numpy()) <= 1e-5
    assert _rel(X, solve.subst_pass_reference(Lt, Wt, torch.tensor(Y), False).numpy()) <= 1e-5


def test_subst_source_nan_in_l(k10_binary):
    nb, bs, q = 4, 128, 8
    _, Lj, W, B = _system(nb * bs, q, bs, seed=5)
    Lj[2 * bs + 3, bs + 9] = np.nan
    Y, X = _run(k10_binary, Lj, W, B)
    assert np.isfinite(Y[:2 * bs]).all() and not np.isfinite(Y[2 * bs:]).all()
    assert not np.isfinite(X[:2 * bs]).all()
