"""The port's hand-written CUDA kernels (K1-K5) against their plain torch
versions, on the card, at small shapes.  Marked ``cuda``: skipped where
torch.cuda.is_available() is False.  On a machine with a card and without
JAX run it alone, without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: both sides compute in float32 in other orders.  A Gram entry
gets 3e-5 of scale^2: near the diagonal d2 = |x|^2 + |y|^2 - 2 x.y cancels to
a rounding error e of about 1e-7 |x|^2 (~4e-6 at d=37), and dk/dd2 is at most
1.5 scale^2 / sigma^2.  matern12 gets 1e-2 of scale^2, since its
r = sqrt(d2) cusp turns e into sqrt(e) (the kernel's own diagonal is exact,
the plain version's is not).  A factor gets 1e-4 relative.  A fit is held
against a float64 fit: its error must stay within 3x that of the float32 fit
on the CPU.  K5's lower triangle gets 1e-5 of the largest |S| entry per
sqrt(k) terms (float32 sums in another order); a gradient of the marginal
likelihood through the card's factorization gets 3x the error of the same
float32 computation on the CPU, both against float64.
"""

import numpy as np
import pytest
import torch

import gpr_tpu_torch as tg
from gpr_tpu_torch.gp import likelihood as lk
from gpr_tpu_torch.ops import _cuda, blocked, fullchol, linalg, syrk
from gpr_tpu_torch.ops import gram as gop

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)


def _relerr(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("form", gop.FORMS)
@pytest.mark.parametrize("tril", [False, True])
def test_gram_kernel(dev, form, tril):
    rng = np.random.default_rng(3)
    n, m, d = 200, (200 if tril else 150), 37
    X = _t(rng.standard_normal((n, d)), dev)
    Y = X if tril else _t(rng.standard_normal((m, d)), dev)
    args = (X, Y, 1.7, 1.2, 0.7 if form == "periodic" else 2.0, 0.37)
    K = gop.gram(*args, form=form, tril=tril)
    R = gop.gram_reference(*args, form=form, tril=tril)
    if tril:
        K, R = torch.tril(K), torch.tril(R)
    tol = (1e-2 if form == "matern12" else 3e-5) * (R.abs().max() if form == "sqdist" else 1.44)
    assert float((K - R).abs().max()) <= tol


@pytest.mark.parametrize("n", [128, 384])
def test_matrix_mode(dev, n):
    rng = np.random.default_rng(4)
    B = rng.standard_normal((n, n))
    A = _t(B @ B.T + n * np.eye(n), dev)
    An = A.clone()
    An[torch.triu(torch.ones_like(A, dtype=torch.bool), 1)] = float("nan")
    L = fullchol.cholesky_fused(An)  # reads the lower triangle only
    Lr, _ = fullchol.fused_cholesky_reference(A)
    assert _relerr(L, Lr) < 1e-4
    assert torch.all(torch.triu(L, 1) == 0)


@pytest.mark.parametrize("n", [128, 300, 512])
def test_gram_mode_and_winv(dev, n):
    rng = np.random.default_rng(5)
    X = _t(rng.standard_normal((n, 5)), dev)
    L, W = fullchol.gram_cholesky_fused(X, 1.3, 2.1, 1.0, 0.7, return_winv=True)
    Lr, Wr = fullchol.fused_cholesky_reference(X, form="gaussian", sigma=1.3, scale=2.1,
                                               diag=0.7)
    assert _relerr(L, Lr) < 1e-4 and _relerr(W, Wr) < 1e-4
    eye = torch.eye(128, device=dev)
    for j in range(W.shape[0]):
        Ljj = L[j * 128:(j + 1) * 128, j * 128:(j + 1) * 128]
        assert float((W[j] @ Ljj - eye).abs().max()) < 1e-4
    assert torch.all(L[n:, :n] == 0) and torch.all(torch.triu(L, 1) == 0)


@pytest.mark.parametrize("where", [3, 380])  # first panel, last panel
def test_failed_pivot_poisons_last_diagonal(dev, where):
    rng = np.random.default_rng(6)
    B = rng.standard_normal((384, 384))
    A = B @ B.T + 384 * np.eye(384)
    A[where, where] = -1e6
    L = fullchol.cholesky_fused(_t(A, dev))
    assert not torch.isfinite(L[-1, -1])


def test_fit_routes_reach_the_kernels(dev):
    rng = np.random.default_rng(7)
    _cuda.reset_launch_counts()
    X = _t(rng.standard_normal((1100, 4)), dev)
    Y = _t(rng.standard_normal((1100, 2)), dev)
    k = tg.Gaussian(2.0, 1.0)
    routes = {
        "fused-gram": tg.fit(k, X[:600], Y[:600], 0.1, use_pallas_gram=True),
        "gram-kernel": tg.fit(k, X[:384], Y[:384], 0.1, use_pallas_gram=True),
        "fused-matrix": tg.fit(k, X[:1024], Y[:1024], 0.1),
        "blocked-syrk": tg.fit(k, X, Y, 0.1),
    }
    Xs = X[:16].cpu()
    for route, gp in routes.items():
        assert gp.route == route
        Xn, Yn = X[:gp.num_samples].cpu(), Y[:gp.num_samples].cpu()
        truth = tg.fit(k, Xn.double(), Yn.double(), float(np.float32(0.1))).predict(Xs.double())
        err_cpu = _relerr(tg.fit(k, Xn, Yn, 0.1).predict(Xs), truth)
        assert _relerr(gp.predict(X[:16]).cpu(), truth) <= 3 * err_cpu
    assert all(v > 0 for v in _cuda.launch_counts().values())


def _syrk_err(S, A22, L21):
    R = A22.double() - L21.double() @ L21.double().T
    tl = torch.tril(torch.ones_like(R, dtype=torch.bool))
    return float((S.double() - R)[tl].abs().max() / R[tl].abs().max()) / max(1, L21.shape[1]) ** 0.5


@pytest.mark.parametrize("m,k", [(200, 130), (64, 16), (65, 17), (1, 1), (130, 0), (300, 1)])
def test_syrk_ragged(dev, m, k):
    rng = np.random.default_rng(8)
    A22, L21 = _t(rng.standard_normal((m, m)), dev), _t(rng.standard_normal((m, k)), dev)
    _cuda.reset_launch_counts()
    S = syrk.syrk_update(A22, L21)
    assert _cuda.launch_counts()["syrk_update"] == 1
    assert _syrk_err(S, A22, L21) < 1e-5
    R = syrk.syrk_update_reference(A22, L21)
    tl = torch.tril(torch.ones_like(R, dtype=torch.bool))
    assert float((S - R)[tl].abs().max()) <= 1e-5 * float(R.abs().max())


def test_syrk_views_in_place_and_upper_tiles_untouched(dev):
    rng = np.random.default_rng(9)
    n, m0 = 333, 130
    W = _t(rng.standard_normal((n, n)), dev)
    A22, L21 = W[m0:, m0:], W[m0:, :m0]
    before, top, left = A22.clone(), W[:m0].clone(), L21.clone()
    expect = syrk.syrk_update_reference(A22.clone(), L21.clone())
    m = n - m0
    # tile (i, j) is above the diagonal band iff its first column >= the end
    # of its row tile: a NaN sentinel there must survive
    r = torch.arange(m, device=dev)[:, None]
    c = torch.arange(m, device=dev)[None, :]
    upper_tiles = c >= (r // 64 + 1) * 64
    A22[upper_tiles] = float("nan")
    out = syrk.syrk_update(A22, L21, out=A22)  # in place on a strided view
    assert out.data_ptr() == A22.data_ptr()
    assert bool(torch.isnan(A22[upper_tiles]).all())
    tl = r >= c
    assert float((A22 - expect)[tl].abs().max()) <= 1e-5 * float(expect.abs().max())
    assert torch.equal(W[:m0], top) and torch.equal(L21, left)  # nothing else written
    assert bool(torch.isfinite(A22[tl]).all()) and not torch.equal(A22[tl], before[tl])


@pytest.mark.parametrize("n", [1100, 2200])
def test_blocked_syrk_route(dev, n):
    rng = np.random.default_rng(10)
    B = rng.standard_normal((n, n))
    A64 = torch.tensor(B @ B.T / n + np.eye(n), device=dev)
    A = A64.float()
    A[torch.triu(torch.ones_like(A, dtype=torch.bool), 1)] = float("nan")  # lower-only read
    assert linalg.cholesky_route(A) == "blocked-syrk"
    _cuda.reset_launch_counts()
    L, j = linalg.safe_cholesky(A)
    assert _cuda.launch_counts()["syrk_update"] > 0 and float(j) == 0.0
    assert torch.all(torch.triu(L, 1) == 0)
    R = torch.linalg.cholesky(A64)
    assert _relerr(L.double(), R) < 1e-4
    bad = A64.float().clone()
    bad[n - 3, n - 3] = -1e6
    assert not torch.isfinite(blocked.cholesky_blocked(bad)[-1, -1])


@pytest.mark.parametrize("n", [1024, 1100])
def test_mll_gradient_on_the_card(dev, n):
    rng = np.random.default_rng(11)
    X = rng.standard_normal((n, 3))
    Y = np.sin(X.sum(1, keepdims=True)) + 0.1 * rng.standard_normal((n, 2))
    k = tg.Gaussian(1.5, 1.0)
    _, g64 = lk.mll_value_and_grad(k, X, Y, 0.1, device="cpu")
    _, g32 = lk.mll_value_and_grad(k, torch.tensor(X, dtype=torch.float32),
                                   torch.tensor(Y, dtype=torch.float32), 0.1)
    _cuda.reset_launch_counts()
    Xc = _t(X, dev)
    assert lk.factor_route(Xc) == ("fused-matrix" if n % 128 == 0 else "blocked-syrk")
    v, g = lk.mll_value_and_grad(k, Xc, _t(Y, dev), 0.1)
    assert g.dtype == torch.float64 and v.dtype == torch.float32
    counts = _cuda.launch_counts()
    assert counts["syrk_update"] > 0 if n % 128 else counts["panel_update"] > 0
    err = float((g.cpu() - g64).abs().max() / g64.abs().max())
    err_cpu = float((g32 - g64).abs().max() / g64.abs().max())
    assert err <= 3 * err_cpu + 1e-6, (err, err_cpu)
