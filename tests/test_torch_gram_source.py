"""K1 gram_tile's and K6 gram_batched's CUDA source (gpr_tpu_torch/csrc/
gram.cu) run on the CPU: compiled by the host's g++ against
tests/cuda_emu/emu.h, a shim that runs every thread of a block as a fiber and
switches at the barriers, so that K6's persistent walk (its items dealt by
write volume to as many blocks as the launcher sees multiprocessors,
EMU_SMS), its mirrored lower tiles and register-carried features, and both
kernels' masked stores are exercised where no CUDA compiler exists.  It says nothing
of speed.  K1's tensor-core path (wgmma, cp.async) is left out of the host
build, so here every form takes the FP32 path; the tensor-core path is held
on the card only (tests/test_torch_cuda.py, chip_smoke.py).

The same numpy inputs go through the emulated kernel, the port's plain
version and JAX's Pallas kernel in interpret mode.  Against the plain
version, the card tests' tolerances: 3e-5 of scale^2, matern12 1e-2, sqdist
3e-5 of the larger of its largest entry and 2 max |x|^2 (at n = 1 its one
entry is the diagonal, which the plain version gets from a cancellation of
|x|^2 terms and the kernel exactly).  Against JAX, whose cross term runs at its bf16x3 tier
(pallas_gram.py:60-81), the tolerances of tests/test_torch_gram.py and
tests/test_torch_gram_batched.py: 3e-4 of scale^2, matern12 5e-3, sqdist
1e-5 of its largest entry.  Each member's matrix is exactly symmetric; the
diagonal term lands on the global diagonal only; in tril mode nothing above
the diagonal is written; the output does not depend on the grid's size.
"""

import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpr_tpu.ops.pallas_gram import gram_pallas, gram_pallas_batched
from gpr_tpu_torch.ops import gram as gop

from cuda_emu_host import build

SENTINEL = 12345.0


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    return build(tmp_path_factory.mktemp("gram"), "gram.cu", "gram_main.cpp")


def _params(form):
    """(B=3, 4) rows (sigma, scale, third, diag), one per member."""
    third = [0.7, 0.5, 0.9] if form == "periodic" else [2.0, 1.5, 3.0]
    return np.array([[1.7, 1.2, third[0], 0.37], [1.3, 0.9, third[1], 0.1], [2.2, 1.4, third[2], 0.01]],
                    np.float32)


def _batched(exe, X, P, form, sms=5):
    B, n, d = X.shape
    w = exe.parent
    P.tofile(w / "P.bin")
    X.tofile(w / "X.bin")
    subprocess.run([str(exe), "batched", str(B), str(n), str(d), str(gop.FORMS.index(form)), str(w / "P.bin"),
                    str(w / "X.bin"), str(w / "K.bin")], check=True, timeout=60,
                   env=dict(os.environ, EMU_SMS=str(sms)))
    return np.fromfile(w / "K.bin", np.float32).reshape(B, n, n)


def _tile(exe, X, Y, args, form, tril):
    (n, d), m = X.shape, Y.shape[0]
    w = exe.parent
    X.tofile(w / "X.bin")
    Y.tofile(w / "Y.bin")
    subprocess.run([str(exe), "tile", str(n), str(m), str(d), str(gop.FORMS.index(form)), *map(str, args),
                    str(int(tril)), str(w / "X.bin"), str(w / "Y.bin"), str(w / "K.bin")], check=True, timeout=60)
    return np.fromfile(w / "K.bin", np.float32).reshape(n, m)


def _err(K, R, form, scale2, X=None):
    if form != "sqdist":
        return float(np.abs(K - R).max() / scale2)
    big = np.abs(R).max() if X is None else max(np.abs(R).max(), 2.0 * float((X * X).sum(-1).max()))
    return float(np.abs(K - R).max() / big)


def _tol(form, jax=False):
    if jax:
        return 1e-5 if form == "sqdist" else (5e-3 if form == "matern12" else 3e-4)
    return 1e-2 if form == "matern12" else 3e-5


@pytest.mark.parametrize("form", gop.FORMS)
def test_gram_batched_source(exe, form):
    P = _params(form)
    rng = np.random.default_rng(gop.FORMS.index(form))
    for n in (1, 63, 65, 200):
        for d in (8, 37):
            X = rng.standard_normal((3, n, d)).astype(np.float32)
            K = _batched(exe, X, P, form)
            assert np.array_equal(K, K.transpose(0, 2, 1)), (n, d)  # each member exactly symmetric
            R = gop.gram_batched_reference(torch.tensor(X), torch.tensor(P), form=form).numpy()
            assert _err(K, R, form, 1.96, X) <= _tol(form), (n, d)
            if (n, d) == (65, 37):  # ragged against both kernels' blocks
                Kj = np.asarray(gram_pallas_batched(jnp.asarray(X), *(P[:, i] for i in range(4)), form=form,
                                                    interpret=True))
                assert _err(K, Kj, form, 1.96) <= _tol(form, jax=True)


@pytest.mark.parametrize("n,d", [(63, 8), (200, 37)])
def test_gram_batched_source_diagonal_and_grid(exe, n, d):
    # sqdist has an exact zero on the diagonal: the diagonal term alone remains
    X = np.random.default_rng(n).standard_normal((3, n, d)).astype(np.float32)
    P = _params("sqdist")
    K = _batched(exe, X, P, "sqdist")
    P0 = P.copy()
    P0[:, 3] = 0.0
    K0 = _batched(exe, X, P0, "sqdist")
    eye = np.eye(n, dtype=bool)
    for b in range(3):
        assert np.all(K[b][eye] == P[b, 3]) and np.all(K0[b][eye] == 0.0)
        assert np.array_equal(K[b][~eye], K0[b][~eye])
    for sms in (1, 13):  # the items dealt to 1 or 13 blocks in place of 5
        assert np.array_equal(_batched(exe, X, P, "gaussian", sms), _batched(exe, X, P, "gaussian"))


@pytest.mark.parametrize("form", gop.FORMS)
@pytest.mark.parametrize("tril", [False, True])
def test_gram_source(exe, form, tril):
    rng = np.random.default_rng(3)
    n, m, d = 200, (200 if tril else 150), 37
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = X if tril else rng.standard_normal((m, d)).astype(np.float32)
    args = (1.7, 1.2, 0.7 if form == "periodic" else 2.0, 0.37)
    K = _tile(exe, X, Y, args, form, tril)
    R = gop.gram_reference(torch.tensor(X), torch.tensor(Y), *args, form=form).numpy()
    Kj = np.asarray(gram_pallas(X, Y, *args, form=form, interpret=True, tril=tril))
    low = np.tril(np.ones((n, m), bool)) if tril else np.ones((n, m), bool)
    assert np.all(K[~low] == SENTINEL)  # tril: nothing above the diagonal written
    assert _err(K[low], R[low], form, 1.44) <= _tol(form)
    assert _err(K[low], Kj[low], form, 1.44) <= _tol(form, jax=True)
