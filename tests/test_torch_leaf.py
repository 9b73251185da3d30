"""The port's whole-leaf Cholesky (gpr_tpu_torch.ops.leaf: K12-K14's plain
versions) and the blocked route under GPR_CHOL_LEAF_INV=1 against gpr_tpu on
the CPU, where the JAX package runs its Pallas leaf kernels in interpret mode
(about 1-2.5 s a leaf).

The same numpy inputs (seeded) go through both packages.  Tolerances:
float64 1e-10 relative to the largest entry (the same exact algorithm with
sums in another order); float32 as tests/test_ops.py:457-499 holds the JAX
kernels, the factor 1e-5 relative and |W L - I| < 1e-4, and W within 1e-5
relative of JAX's.  The fit and the likelihood run in float64 and agree to
1e-9 relative (the leaves' inverses turn the column solves into products,
in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu.ops.blocked as jblk
import gpr_tpu.ops.pallas_leaf as jleaf
import gpr_tpu_torch as tg
from gpr_tpu.gp import likelihood as jlk
from gpr_tpu.ops import linalg as jlin
from gpr_tpu_torch.gp import likelihood as tlk
from gpr_tpu_torch.ops import _cuda, blocked, leaf, linalg

TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _spd(n, dtype, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return (M @ M.T + n * np.eye(n)).astype(dtype)


def _nan_upper(A):
    A = np.array(A)
    A[np.triu_indices(A.shape[0], 1)] = np.nan
    return A


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("kernel", ["leaf_cholesky", "leaf_cholesky_wi", "tri_inv_leaf"])
def test_leaf_kernels_match_jax(kernel, n, dtype):
    A = _spd(n, dtype, seed=n)
    eye = np.eye(n)
    if kernel == "tri_inv_leaf":
        Lin = np.linalg.cholesky(A.astype(np.float64)).astype(dtype)
        Wj = np.asarray(jleaf.tri_inv_leaf(jnp.asarray(_nan_upper(Lin)), interpret=True))
        W = leaf.tri_inv_leaf(torch.tensor(_nan_upper(Lin))).numpy()
        assert W.dtype == dtype and np.all(np.triu(W, 1) == 0)
        assert _rel(W, Wj) < TOL[dtype]
        assert np.abs(W.astype(np.float64) @ Lin - eye).max() < (1e-10 if dtype == np.float64 else 1e-4)
        return
    out = getattr(jleaf, kernel)(jnp.asarray(_nan_upper(A)), interpret=True)
    port = getattr(leaf, kernel)(torch.tensor(_nan_upper(A)))
    if kernel == "leaf_cholesky":
        out, port = (out,), (port,)
    L, Lj = port[0].numpy(), np.asarray(out[0])
    assert L.dtype == dtype and np.all(np.triu(L, 1) == 0)
    assert _rel(L, Lj) < TOL[dtype]
    if kernel == "leaf_cholesky_wi":
        W, Wj = port[1].numpy(), np.asarray(out[1])
        assert np.all(np.triu(W, 1) == 0)
        assert _rel(W, Wj) < TOL[dtype]
        assert np.abs(W.astype(np.float64) @ L - eye).max() < (1e-10 if dtype == np.float64 else 1e-4)


@pytest.mark.parametrize("where", [3, 700, 1023])
def test_failed_pivot_poisons_the_leaf(where):
    A = _spd(1024, np.float64, seed=9)
    A[where, where] = -A[where, where]
    At = torch.tensor(_nan_upper(A))
    L, W = leaf.leaf_cholesky_wi(At)
    assert np.isnan(float(L[-1, -1])) and not bool(torch.isfinite(W).all())
    assert np.isnan(float(leaf.leaf_cholesky(At)[-1, -1]))
    assert bool(torch.all(torch.triu(L, 1) == 0))  # exact zeros, not the input's NaN


def test_in_place_and_strided_views():
    A = torch.tensor(_spd(512, np.float32, seed=2))
    buf = torch.full((600, 700), float("nan"))
    view = buf[40:552, 100:612]
    view.copy_(torch.tril(A))  # NaN stays above the diagonal
    L, W = leaf.leaf_cholesky_wi(view, out=view)
    assert L.data_ptr() == view.data_ptr() and L.stride() == (700, 1)
    ref = np.linalg.cholesky(A.double().numpy())
    assert _rel(view.numpy(), ref) < 1e-5 and bool(torch.all(torch.triu(view, 1) == 0))
    assert bool(torch.isnan(buf[:40]).all())  # nothing outside the view is touched
    assert _rel(leaf.leaf_cholesky(A), ref) < 1e-5
    assert _rel(leaf.tri_inv_leaf(view), W) < 1e-5


def test_shape_gate_and_usable():
    for n in (128, 384, 1280):
        with pytest.raises(ValueError, match="n % 256"):
            leaf.leaf_cholesky_wi(torch.eye(n))
        assert not leaf.leaf_usable(n, torch.float32, "cuda")
    for A, out in ((torch.zeros(256, 256).t(), None), (torch.eye(256), torch.zeros(256, 256).t())):
        with pytest.raises(ValueError, match="row-major"):  # the kernels index rows
            leaf.leaf_cholesky(A, out=out)
    assert leaf.leaf_usable(1024, torch.float32, "cuda")
    assert not leaf.leaf_usable(1024, torch.float64, "cuda")  # cholesky_ex there, as JAX on the TPU
    assert leaf.leaf_usable(768, torch.float64, "cpu")  # the plain version, as JAX's interpret branch


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_blocked_leaf_inverse_reaches_the_leaves(dtype, monkeypatch):
    # n = 2048, leaf 512: four 512-leaves (JAX's own test, n = 1536, has
    # leaves of 384 and never reaches its kernel)
    A = _spd(2048, dtype, seed=6) / 2048
    jcalls, tcalls = [], []
    jorig, torig = jleaf.leaf_cholesky_wi, blocked.leaf_cholesky_wi
    monkeypatch.setattr(jleaf, "leaf_cholesky_wi",
                        lambda M, **kw: jcalls.append(M.shape) or jorig(M, **kw))
    monkeypatch.setattr(blocked, "leaf_cholesky_wi",
                        lambda M, **kw: tcalls.append(tuple(M.shape)) or torig(M, **kw))
    Lj = np.asarray(jblk.cholesky_blocked(jnp.asarray(A), leaf=512, leaf_inverse=True))
    An = torch.tensor(_nan_upper(A))
    _cuda.reset_launch_counts()
    L = blocked.cholesky_blocked(An, leaf=512, leaf_inverse=True).numpy()
    assert tcalls == [(512, 512)] * 4 and len(jcalls) == 4
    assert sum(_cuda.launch_counts().values()) == 0  # the plain versions on the CPU
    assert np.all(np.triu(L, 1) == 0)
    assert _rel(L, np.tril(Lj)) < TOL[dtype]
    assert _rel(L, blocked.cholesky_blocked(An, leaf=512, leaf_inverse=False).numpy()) < TOL[dtype]


@pytest.fixture
def leaf_switch(monkeypatch):
    """Both packages under GPR_CHOL_SCHEDULE=recursive GPR_CHOL_LEAF_INV=1,
    counting the leaf calls of each (JAX's when it traces: its jitter retry is
    a while_loop whose body traces the factorization once more); JAX's caches
    are cleared on both sides, as it reads the switches when it traces."""
    monkeypatch.setenv("GPR_CHOL_SCHEDULE", "recursive")
    monkeypatch.setenv("GPR_CHOL_LEAF_INV", "1")
    calls = {"jax": [], "port": []}
    jorig, torig = jleaf.leaf_cholesky_wi, blocked.leaf_cholesky_wi
    monkeypatch.setattr(jleaf, "leaf_cholesky_wi",
                        lambda M, **kw: calls["jax"].append(M.shape[0]) or jorig(M, **kw))
    monkeypatch.setattr(blocked, "leaf_cholesky_wi",
                        lambda M, **kw: calls["port"].append(M.shape[0]) or torig(M, **kw))
    jax.clear_caches()
    yield calls
    jax.clear_caches()


def _data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 5))
    Y = np.sin(X[:, :3]) + 0.1 * rng.standard_normal((n, 3))
    return X, Y, rng.standard_normal((16, 5))


def test_safe_cholesky_under_the_switch(leaf_switch):
    K = _spd(2048, np.float64, seed=21) / 2048
    Kt = torch.tensor(K)
    assert linalg.cholesky_route(Kt) == "blocked-leaf"
    L, jit = linalg.safe_cholesky(Kt)
    Lj, jitj = jlin.safe_cholesky(jnp.asarray(K))
    assert float(jit) == 0.0 and float(jitj) == 0.0
    assert leaf_switch["port"] == [1024, 1024] and set(leaf_switch["jax"]) == {1024}
    assert _rel(L.numpy(), np.tril(np.asarray(Lj))) < 1e-10


# n = 2048: leaves 1024, 1024; n = 3773: leaves 1024, 896, 1024, 829, of
# which the two of 1024 pass the gate
@pytest.mark.parametrize("n, leaves", [(2048, [1024, 1024]), (3773, [1024, 1024])])
def test_fit_and_mll_under_the_switch(n, leaves, leaf_switch):
    X, Y, Xs = _data(n, seed=n)
    sigma = 0.1
    tk, jk = tg.Gaussian(2.0, 1.0), jg.parse_kernel("GaussianKernel(2,1,)")
    gp = tg.fit(tk, X, Y, sigma=sigma, device="cpu")
    gj = jg.fit(jk, X, Y, sigma=sigma)
    assert gp.route == "blocked-leaf"
    assert leaf_switch["port"] == leaves and leaf_switch["jax"][:2] == leaves
    assert _rel(gp.L.numpy(), np.tril(np.asarray(gj.L))) < 1e-10  # safe_cholesky's factor
    assert _rel(gp.alpha.numpy(), np.asarray(gj.alpha)) < 1e-9
    assert _rel(gp.predict(torch.tensor(Xs)).numpy(), np.asarray(gj.predict(Xs))) < 1e-9
    assert _rel(gp.credible_interval(torch.tensor(Xs)).numpy(),
                np.asarray(gj.credible_interval(Xs))) < 1e-9
    vt, gt = tlk.mll_value_and_grad(tk, X, Y, sigma, device="cpu")
    vj, gjr = jlk.mll_value_and_grad(jk, X, Y, sigma)
    assert leaf_switch["port"] == 2 * leaves
    assert _rel(vt.numpy(), np.asarray(vj)) < 1e-9 and _rel(gt.numpy(), np.asarray(gjr)) < 1e-9
