"""The port's narrow Cholesky solve (gpr_tpu_torch.ops.solve, and its
dispatch in ops.linalg.cho_solve) against gpr_tpu.ops.pallas_solve, whose
Pallas kernels run in interpret mode on the CPU as tests/test_ops.py:621-773
runs them.  On CPU tensors the port runs the plain versions of K10 and K11.

Tolerances: JAX's own, 5e-6 of the largest entry against a float64-grade
solve (scipy's cho_solve of the same float32 factor), for both packages; the
two float32 results differ from each other by the sum of those.  Gradients:
2e-5 of the largest entry, as JAX's gradient test.  The diagonal-tile
inverses: W L = I to 2e-5, as JAX's test, and 1e-5 of the largest entry
between the packages.  K11's blocked order on the card (32-wide diagonal
inverses by row elimination, then the doubling levels h = 32 .. bs / 2,
each product summed by 32-deep float32 partials) is emulated here in float32
torch and held to JAX's Pallas kernel the same way, and to a float64 inverse
of an ill-conditioned tile (cond ~1e4) at 3x the plain version's error.  The narrow-schedule MLL is a float32 computation whose
error against float64 is set by the conditioning of K + sigma^2 I, so the
port's error must stay within 3x JAX's (the ratio gate of ADVICE.md:5).
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax
import jax.numpy as jnp

import gpr_tpu as jg
import gpr_tpu_torch as tg
from gpr_tpu.gp import likelihood as jlk
from gpr_tpu.ops import linalg as jl
from gpr_tpu.ops import pallas_solve as jps
from gpr_tpu_torch.gp import likelihood as tlk
from gpr_tpu_torch.ops import linalg as tl
from gpr_tpu_torch.ops import solve as ts

REL = 5e-6


def _system(n, q, seed=16, junk=True):
    # tests/test_ops.py:630-634's system, with junk above the diagonal
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 64)).astype(np.float32)
    A = X @ X.T / 64 + 4.0 * np.eye(n, dtype=np.float32)
    Lh = np.linalg.cholesky(A).astype(np.float32)
    up = np.triu(rng.standard_normal((n, n)).astype(np.float32), 1) if junk else 0.0
    return Lh, Lh + up, rng.standard_normal((n, q)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n,q,bs,diag_inv", [
    (1024, 1, 512, "xla"), (1024, 8, 512, "xla"), (1024, 128, 512, "xla"),
    (3072, 8, 1024, "xla"), (2048, 8, 512, "pallas"), (1024, 8, 256, "pallas"),
    (3072, 8, 1024, "pallas")])
def test_cho_solve_narrow_matches_jax(n, q, bs, diag_inv):
    Lh, Lj, B = _system(n, q)
    got = ts.cho_solve_narrow(torch.tensor(Lj), torch.tensor(B), bs=bs, diag_inv=diag_inv).numpy()
    ref = sla.cho_solve((Lh, True), B)
    jax_x = np.asarray(jps.cho_solve_narrow(jnp.asarray(Lj), jnp.asarray(B), bs=bs, interpret=True,
                                            diag_inv=diag_inv))
    assert _rel(got, ref) < REL and _rel(jax_x, ref) < REL
    assert _rel(got, jax_x) < 2 * REL


def test_vector_rhs_and_env_scheme(monkeypatch):
    Lh, Lj, B = _system(1024, 1, seed=17)
    b = B[:, 0]
    monkeypatch.setenv("GPR_SOLVE_DIAGINV", "pallas")
    calls = []
    orig = ts.diag_tri_inv
    monkeypatch.setattr(ts, "diag_tri_inv", lambda L, bs: calls.append(bs) or orig(L, bs))
    x = ts.cho_solve_narrow(torch.tensor(Lj), torch.tensor(b))
    assert x.shape == (1024,) and calls == [512]  # the scheme is read at call time
    np.testing.assert_allclose(x.numpy(), sla.cho_solve((Lh, True), b), atol=1e-4)
    monkeypatch.setenv("GPR_SOLVE_DIAGINV", "bogus")
    with pytest.raises(ValueError):
        ts.cho_solve_narrow(torch.tensor(Lj), torch.tensor(b))


@pytest.mark.parametrize("n,bs", [(1024, 256), (1024, 512), (2048, 1024)])
def test_diag_block_inverses_match_jax(n, bs):
    Lh, Lj, _ = _system(n, 1, seed=19)
    W = ts.diag_block_inverses(torch.tensor(Lj), bs, "pallas").numpy()
    Wj = np.asarray(jps._diag_block_inverses_pallas(jnp.asarray(Lj), bs, interpret=True))
    assert _rel(W, Wj) < 1e-5
    for i in range(n // bs):
        blk = Lh[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs]
        np.testing.assert_allclose(W[i] @ blk, np.eye(bs, dtype=np.float32), atol=2e-5)
        assert np.all(np.triu(W[i], 1) == 0)
    Wx = ts.diag_block_inverses(torch.tensor(Lj), bs, "xla").numpy()
    assert _rel(W, Wx) < 1e-5


def _chunked_matmul(P, Q, k=32):
    """P @ Q summed as K11 sums it: one float32 partial per 32-deep chunk,
    folded into a float32 running sum."""
    run = torch.zeros(P.shape[:-1] + Q.shape[-1:], dtype=P.dtype)
    for k0 in range(0, P.shape[-1], k):
        run += P[..., k0:k0 + k] @ Q[..., k0:k0 + k, :]
    return run


def _k11_blocked_order(L, bs, nb_w=32):
    """csrc/solve.cu's K11 in float32 torch: each diagonal block's inverse by
    row elimination (tri_inv_diag), then for h = 32, 64, ... < bs every pair
    of h-wide blocks joined by X = -inv(D) (C inv(A)) (tri_inv_level)."""
    D = torch.tril(ts._diag_tiles(L, bs))
    W = torch.zeros_like(D)
    for c0 in range(0, bs, nb_w):
        w = min(nb_w, bs - c0)
        B = D[:, c0:c0 + w, c0:c0 + w]
        V = torch.eye(w).expand_as(B).clone()
        for m in range(w):
            V[:, m] *= 1.0 / B[:, m, m:m + 1]
            V[:, m + 1:] -= B[:, m + 1:, m:m + 1] * V[:, m:m + 1]
        W[:, c0:c0 + w, c0:c0 + w] = V
    h = nb_w
    while h < bs:
        for c0 in range(0, bs - h, 2 * h):
            r0, r1 = c0 + h, min(c0 + 2 * h, bs)
            T = _chunked_matmul(D[:, r0:r1, c0:r0], W[:, c0:r0, c0:r0])
            W[:, r0:r1, c0:r0] = -_chunked_matmul(W[:, r0:r1, r0:r1], T)
        h *= 2
    return W


@pytest.mark.parametrize("bs", [256, 512])
def test_k11_blocked_order_matches_jax(bs):
    Lh, Lj, _ = _system(1024, 1, seed=23)
    W = _k11_blocked_order(torch.tensor(Lj), bs).numpy()
    Wj = np.asarray(jps._diag_block_inverses_pallas(jnp.asarray(Lj), bs, interpret=True))
    assert _rel(W, Wj) < 1e-5 and np.all(np.triu(W, 1) == 0)
    for i in range(1024 // bs):
        blk = Lh[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs]
        np.testing.assert_allclose(W[i] @ blk, np.eye(bs, dtype=np.float32), atol=2e-5)


@pytest.mark.parametrize("bs", [48, 512])
def test_k11_blocked_order_precision(bs):
    # a factor tile of cond ~1e4 (A's eigenvalues 1 .. 1e-8); the doubling's
    # error against float64 within 3x that of the plain substitution
    rng = np.random.default_rng(24)
    Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
    A = (Q * np.logspace(0, -8, bs)) @ Q.T
    Lh = np.linalg.cholesky(A + 1e-12 * np.eye(bs)).astype(np.float32)
    truth = np.linalg.inv(Lh.astype(np.float64))
    assert 3e3 < np.linalg.cond(Lh.astype(np.float64)) < 3e4
    err = _rel(_k11_blocked_order(torch.tensor(Lh), bs)[0], truth)
    err_plain = _rel(ts.diag_tri_inv_reference(torch.tensor(Lh), bs)[0], truth)
    assert err <= 3 * err_plain, (err, err_plain)


def test_kernel_wrappers_check_their_arguments():
    L = torch.eye(1024)
    with pytest.raises(ValueError):
        ts.diag_tri_inv(L, 1024)  # above K11's 512: bs 1024 goes by pairs
    with pytest.raises(ValueError):
        ts.diag_tri_inv(L.double(), 256)
    with pytest.raises(ValueError):
        ts.subst_pass(L, torch.zeros((2, 512, 512)), torch.zeros((1000, 2)), True)
    with pytest.raises(ValueError):
        ts.cho_solve_narrow(torch.eye(1000), torch.zeros((1000, 2)))


def test_gradient_matches_jax():
    # tests/test_ops.py:700-735 with the port's autograd.Function
    rng = np.random.default_rng(21)
    n, q = 1024, 4
    X = rng.standard_normal((n, 64)).astype(np.float32)
    A = X @ X.T / 64 + 4.0 * np.eye(n, dtype=np.float32)
    Lh = np.linalg.cholesky(A).astype(np.float32)
    B = rng.standard_normal((n, q)).astype(np.float32)
    Wt = rng.standard_normal((n, q)).astype(np.float32)
    gLj, gBj = jax.grad(lambda L, B: jnp.sum(jps.cho_solve_narrow(L, B, interpret=True) * Wt),
                        argnums=(0, 1))(jnp.asarray(Lh), jnp.asarray(B))
    L = torch.tensor(Lh, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    (ts.cho_solve_narrow(L, Bt) * torch.tensor(Wt)).sum().backward()
    np.testing.assert_allclose(L.grad.numpy(), np.tril(np.asarray(gLj)),
                               atol=2e-5 * float(np.abs(gLj).max()))
    assert np.all(np.triu(L.grad.numpy(), 1) == 0)
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gBj), atol=2e-5 * float(np.abs(gBj).max()))


def test_cho_solve_dispatch_env(monkeypatch):
    # tests/test_ops.py:677-698: the narrow schedule, and the fallbacks
    Lh, _, B = _system(1024, 8, seed=18, junk=False)
    L = torch.tensor(Lh)
    assert tl.solve_route(L, torch.tensor(B)) == "triangular"  # the default schedule
    monkeypatch.setenv("GPR_SOLVE_SCHEDULE", "narrow")
    calls = []
    orig = ts.subst_pass
    monkeypatch.setattr(ts, "subst_pass", lambda *a: calls.append(a[3]) or orig(*a))
    assert tl.solve_route(L, torch.tensor(B)) == "narrow"
    got = tl.cho_solve(L, torch.tensor(B)).numpy()
    assert calls == [True, False]
    assert _rel(got, sla.cho_solve((Lh, True), B)) < REL
    jgot = np.asarray(jl.cho_solve(jnp.asarray(Lh), jnp.asarray(B)))
    assert _rel(got, jgot) < 2 * REL
    # q > 128 falls back to the triangular solves, as JAX's to its blocked ones
    Bw = np.random.default_rng(3).standard_normal((1024, 130)).astype(np.float32)
    assert tl.solve_route(L, torch.tensor(Bw)) == "triangular"
    np.testing.assert_allclose(tl.cho_solve(L, torch.tensor(Bw)).numpy(),
                               sla.cho_solve((Lh, True), Bw), atol=1e-4)
    assert calls == [True, False]
    # float64, n % 512 != 0 and n < 1024 take the triangular solves too
    assert tl.solve_route(L.double(), torch.tensor(B).double()) == "triangular"
    assert tl.solve_route(L[:768, :768], torch.tensor(B[:768])) == "triangular"
    Lo = torch.tensor(np.linalg.cholesky(np.eye(1100) * 2.0).astype(np.float32))
    assert tl.solve_route(Lo, torch.zeros(1100)) == "triangular"


def test_narrow_mll_matches_jax(monkeypatch):
    # tests/test_ops.py:737-756: value and gradient of the MLL under the
    # narrow schedule, float32, n = 1024, held against float64 in both packages
    monkeypatch.setenv("GPR_SOLVE_SCHEDULE", "narrow")
    rng = np.random.default_rng(22)
    X = rng.standard_normal((1024, 3))
    Y = np.sin(X.sum(1, keepdims=True)) + 0.1 * rng.standard_normal((1024, 2))
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    kstr = "GaussianKernel(1.5,1,)"
    calls = []
    orig = ts._narrow_impl
    monkeypatch.setattr(ts, "_narrow_impl", lambda *a: calls.append(1) or orig(*a))
    v, g = tlk.mll_value_and_grad(tg.parse_kernel(kstr), X32, Y32, 0.1, device="cpu")
    assert len(calls) == 2  # the forward solve and the one in its backward
    # JAX's test differentiates mll_scalar in float32 parameters
    vj, gj = jax.value_and_grad(
        lambda p: jlk.mll_scalar(jg.Gaussian(p[0], p[1]), jnp.asarray(X32), jnp.asarray(Y32), 0.1)
    )(jnp.asarray([1.5, 1.0], jnp.float32))
    monkeypatch.setenv("GPR_SOLVE_SCHEDULE", "blocked")
    v64, g64 = tlk.mll_value_and_grad(tg.parse_kernel(kstr), X32.astype(np.float64),
                                      Y32.astype(np.float64), float(np.float32(0.1)), device="cpu")
    v, v64 = v.sum().numpy(), v64.sum().numpy()
    assert _rel(v, v64) <= 3 * _rel(np.asarray(vj), v64) + 1e-7
    assert _rel(g.numpy(), g64.numpy()) <= 3 * _rel(np.asarray(gj), g64.numpy()) + 1e-6
