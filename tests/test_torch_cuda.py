"""The port's hand-written CUDA kernels (K1-K20) against their plain torch
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
float32 computation on the CPU, both against float64.  K6 takes K1's
tolerances; a K7 factor gets 1e-5 of its largest entry (the kernel pivots
with 1.0f / sqrtf(piv) and scaled columns, the plain version with 1 / piv
and unscaled ones).  K8's W gets 1e-4 relative (the kernel forms W by row
solves beside its blocked factor, the plain version by a substitution inside
its column sweep), at every width b = 1-128; K9's factor 1e-5, its alpha and
W 1e-4 relative, against the plain version and a float64 solve.  K10's sweep gets 1e-5 of
the largest entry against its plain version (both sum 128-term pieces in
float32, in other orders), K11's inverse 1e-4 relative and W L = I to 1e-4;
the narrow solve is held to a float64 solve at JAX's own 5e-6 relative
(tests/test_ops.py:621-773) on JAX's cases, and at 4 times that on junk-filled
factors.  A K7 factor is also held at every width b = 1-128 (the kernel pads
to a multiple of 32 with the identity).
K12-K14's factor and inverse get 1e-5 relative against their plain versions
(K12 by 32-wide blocks, K13's and K14's W by 32-wide diagonal blocks and
64x64 product tiles summed in pieces of 32 to 128 terms, the plain versions
by 64-wide blocks; float32 sums in other orders) and |W L - I| < 1e-4, as
tests/test_ops.py:457-499 holds JAX's leaf kernels; K12, K14 and K15 are
bit-equal from call to call, K13's factor is K12's and its W is K14's of
that factor, bit for bit.  K15
and K17 (a panel factored by 32-blocks and products with W, against
cholesky_ex and a triangular solve) and the in-place factorization get 1e-5
relative; K16's
tiles 1e-5 of the largest entry (K5's bound; two calls bit-identical); K18
is bit-exact.  K19 and K20
get 1e-5 of the largest entry against their plain versions (the gate
tests/test_ops.py:318 puts on JAX's kernel) and ||L L^T - A|| / ||A|| < 1e-5
(Frobenius, float64 arithmetic on the float32 factor).
The serve app's CUDA graph replays its eager program's kernels on the same
inputs: equal bit for bit.  An order-3 warp in float64 on the card gets
1e-10 of the image's range against scipy, in float32 1e-5 (float32 taps of
the prefilter).  median_filter is a selection, equal to its CPU run;
histogram_matching gets 1e-12 (float64) and 2e-6 (float32) of its range
against its CPU run (the same elementwise arithmetic).
"""

import os

import numpy as np
import pytest
import torch

import gpr_tpu_torch as tg
from gpr_tpu_torch.gp import likelihood as lk
from gpr_tpu_torch.gp import batched as fleet
from gpr_tpu_torch.gp import exact
from gpr_tpu_torch.ops import _cuda, blocked, chol, crout, fullchol, leaf, linalg, solve, syrk
from gpr_tpu_torch.ops import inplace_chol, panel
from gpr_tpu_torch.ops import batched as fleet_ops
from gpr_tpu_torch.ops import gram as gop
from torch_split_order import panel_update_split

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


def _gram_into(K, X, Y, args, form, tril):
    """K1 straight into the buffer K (a sentinel survives where it writes nothing)."""
    _cuda.GRAM.launch(X.device, X.data_ptr(), Y.data_ptr(), K.data_ptr(), X.shape[0], Y.shape[0], X.shape[1],
                      gop.FORMS.index(form), *(float(a) for a in args), int(tril))
    torch.cuda.synchronize()
    return K


# The tensor-core path (gaussian, rq, matern32, matern52, sqdist at d % 4 == 0,
# d >= 32) and the FP32 path (matern12, periodic) at widths around the 32-deep
# k-slices, ragged against the 128 tiles; |x|^2 ~ 4 keeps K away from 0.  At
# 3000 (300 lower tiles) and 2600 x 2900 (483 tiles) each of the 132 blocks
# walks several tiles: the slices streamed across tile boundaries, A's row
# block kept (d <= 128) or streamed (d = 132), each finished tile written
# under the next one's products.
@pytest.mark.parametrize("form", gop.FORMS)
@pytest.mark.parametrize("d", [32, 64, 128, 132])
def test_gram_kernel_widths(dev, form, d):
    rng = np.random.default_rng(d)
    for n, m, tril in ((200, 150, False), (383, 383, True), (200, 200, True), (383, 129, False), (3000, 3000, True),
                       (2600, 2900, False)):
        X = _t(rng.standard_normal((n, d)) * (2.0 / np.sqrt(d)), dev)
        Y = X if tril else _t(rng.standard_normal((m, d)) * (2.0 / np.sqrt(d)), dev)
        args = (1.7, 1.2, 0.7 if form == "periodic" else 2.0, 0.37)
        K = _gram_into(torch.full((n, m), 12345.0, device=dev), X, Y, args, form, tril)
        R = gop.gram_reference(X, Y, *args, form=form)
        if tril:
            low = torch.ones((n, m), dtype=torch.bool, device=dev).tril_()
            assert bool(torch.all(K[~low] == 12345.0))  # nothing above the diagonal written
            K, R = K[low], R[low]
        tol = (1e-2 if form == "matern12" else 3e-5) * (R.abs().max() if form == "sqdist" else 1.44)
        assert float((K - R).abs().max()) <= tol, (n, m, tril)


@pytest.mark.parametrize("form", ["gaussian", "matern52", "matern12"])
def test_gram_kernel_full_width_tril(dev, form):
    n, d = 16383, 128
    X = _t(np.random.default_rng(5).standard_normal((n, d)) * (2.0 / np.sqrt(d)), dev)
    args = (1.7, 1.2, 2.0, 0.37)
    K = _gram_into(torch.full((n, n), 12345.0, device=dev), X, X, args, form, True)
    low = torch.ones((n, n), dtype=torch.bool, device=dev).tril_()
    assert bool(torch.all(K[~low] == 12345.0))
    R = gop.gram_reference(X, X, *args, form=form)
    assert float((K - R)[low].abs().max()) <= (1e-2 if form == "matern12" else 3e-5) * 1.44


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


def _factor_to(src, n_pad, j, gram=()):
    """L and W with panels 0..j-1 factored by the kernels (panel j not yet)."""
    L = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=src.device)
    W = torch.zeros((n_pad // 128, 128, 128), dtype=torch.float32, device=src.device)
    for i in range(j):
        fullchol.panel_update(L, i, src, *gram)
        fullchol.diag_factor_inv(L, W, i)
        fullchol.panel_solve(L, W, i)
    return L, W


@pytest.mark.parametrize("mode", ["matrix", "gram"])
@pytest.mark.parametrize("j", [1, 16, 31])
def test_panel_update_split_k(dev, mode, j):
    # K2 on the tensor cores (3xTF32) with the k ranges split as planned,
    # against its plain version summing in the same order and as one
    # product: the factor's 1e-4
    rng = np.random.default_rng(20 + j)
    n = 4096
    if mode == "matrix":
        B = rng.standard_normal((n, 64))
        src, gram = _t(B @ B.T / 64 + np.eye(n), dev), ()
    else:
        src, gram = _t(rng.standard_normal((n - 50, 8)), dev), ("gaussian", 2.0, 1.3, 1.0, 0.05)
    L, _ = _factor_to(src, n, j, gram)
    Lk, Lr, L1 = L.clone(), L.clone(), L.clone()
    fullchol.panel_update(Lk, j, src, *gram)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = fullchol._split_plan(n, j, sms)
    assert blocks == (min((j - 1) * (32 - j), sms - 1) if j > 1 else 0)
    panel_update_split(Lr, j, src, *gram, blocks=blocks)
    fullchol.panel_update_reference(L1, j, src, *gram)
    cols = slice(j * 128, (j + 1) * 128)
    assert _relerr(Lk[:, cols], Lr[:, cols]) < 1e-4
    assert _relerr(Lk[:, cols], L1[:, cols]) < 1e-4
    assert torch.all(Lk[:j * 128, cols] == 0)
    assert torch.equal(Lk[:, :j * 128], L[:, :j * 128])  # nothing else written


@pytest.mark.parametrize("mode", ["matrix", "gram"])
def test_factorization_is_bit_identical(dev, mode):
    # split-K partials are added in a fixed order without atomics
    rng = np.random.default_rng(24)
    n = 4096
    if mode == "matrix":
        B = rng.standard_normal((n, 64))
        A = _t(B @ B.T / 64 + np.eye(n), dev)
        L1, L2 = fullchol.cholesky_fused(A), fullchol.cholesky_fused(A)
    else:
        X = _t(rng.standard_normal((n, 8)), dev)
        L1, L2 = (fullchol.gram_cholesky_fused(X, 2.0, 1.3, 1.0, 0.05) for _ in range(2))
    assert torch.isfinite(L1[-1, -1])
    assert torch.equal(L1, L2)


def _seq_factor(src, n_pad, gram=()):
    """The kernels' stages one after another on one stream (no lookahead)."""
    L = torch.empty((n_pad, n_pad), dtype=torch.float32, device=src.device)
    W = torch.empty((n_pad // 128, 128, 128), dtype=torch.float32, device=src.device)
    for j in range(n_pad // 128):
        fullchol.panel_update(L, j, src, *gram)
        fullchol.diag_factor_inv(L, W, j)
        fullchol.panel_solve(L, W, j)
    return L, W


@pytest.mark.parametrize("mode,n", [("matrix", 4096), ("gram", 4096), ("gram", 3773)])
def test_lookahead_matches_the_sequential_steps(dev, mode, n):
    # the lookahead moves no sum, only when each runs: its factor is
    # bit-identical to the stages run in one stream, and to itself; one
    # call counts each stage it launched
    rng = np.random.default_rng(27)
    nc = fullchol.padded_size(n) // 128
    _cuda.reset_launch_counts()
    if mode == "matrix":
        B = rng.standard_normal((n, 64))
        src, gram = _t(B @ B.T / 64 + np.eye(n), dev), ()
        L1 = fullchol.cholesky_fused(src)
        c = _cuda.launch_counts()
        assert (c["panel_update"], c["diag_factor_inv"], c["panel_solve"]) == (3 * nc - 3, nc, nc - 1)
        L2 = fullchol.cholesky_fused(src)
        W1 = fullchol._factor(src, n, gram, fullchol._KERNEL_STEPS)[1]
    else:
        src, gram = _t(rng.standard_normal((n, 8)), dev), ("gaussian", 2.0, 1.3, 1.0, 0.05)
        L1, W1 = fullchol.gram_cholesky_fused(src, *gram[1:], form="gaussian", return_winv=True)
        L2 = fullchol.gram_cholesky_fused(src, *gram[1:], form="gaussian")
    Ls, Ws = _seq_factor(src, fullchol.padded_size(n), gram)
    assert torch.isfinite(L1[-1, -1])
    assert torch.equal(L1, L2) and torch.equal(L1, Ls) and torch.equal(W1, Ws)


@pytest.mark.parametrize("where", [0, 31, 32, 127])  # the 32-block edges of K3
def test_lookahead_failed_pivot(dev, where):
    # a failed pivot in a middle panel, while the next panel's products run
    # beside its K3 and K4, still poisons L[-1, -1]
    rng = np.random.default_rng(28)
    n = 1024
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    A[512 + where, 512 + where] = -1e6  # panel 4 of 8
    L = fullchol.cholesky_fused(_t(A, dev))
    assert not torch.isfinite(L[-1, -1])
    assert torch.isfinite(L[:512, :512]).all()  # the panels before are factored


@pytest.mark.parametrize("n,j", [(16384, 0), (16384, 64), (16384, 126), (3840, 0), (3840, 13),
                                 (3840, 28)])
def test_panel_solve_kernel(dev, n, j):
    # K4 (FP32 FMA, 32-row blocks, W_j's zero upper terms skipped) against
    # its plain version at the n=16384 fit's panels and at the n=3773 fit's
    # padded size: 1e-5 of the largest entry; in place, nothing outside the
    # panel's rows below written
    g = torch.Generator(device=dev).manual_seed(29 + j)
    L = torch.randn((n, n), generator=g, device=dev)
    W = torch.zeros((n // 128, 128, 128), device=dev)
    T = torch.randn((128, 128), generator=g, device=dev).tril_() / 16 + torch.eye(128, device=dev)
    W[j] = torch.linalg.solve_triangular(T, torch.eye(128, device=dev), upper=False)
    Lr = L.clone()
    _cuda.reset_launch_counts()
    fullchol.panel_solve(L, W, j)
    assert _cuda.launch_counts()["panel_solve"] == 1
    fullchol.panel_solve_reference(Lr, W, j)
    cols = slice(j * 128, (j + 1) * 128)
    below = L[(j + 1) * 128:, cols]
    assert float((below - Lr[(j + 1) * 128:, cols]).abs().max()) <= 1e-5 * float(below.abs().max())
    L[(j + 1) * 128:, cols] = Lr[(j + 1) * 128:, cols]
    assert torch.equal(L, Lr)


def test_diag_factor_inv_kernel(dev):
    # K3 reads the lower triangle of the diagonal block only and writes exact
    # zeros above it, in L_jj and in W_j
    rng = np.random.default_rng(25)
    B = rng.standard_normal((128, 128))
    P = _t(B @ B.T / 128 + np.eye(128), dev)
    L = torch.zeros((256, 256), dtype=torch.float32, device=dev)
    L[128:, 128:] = P
    L[128:, 128:][torch.triu(torch.ones_like(P, dtype=torch.bool), 1)] = float("nan")
    W = torch.zeros((2, 128, 128), dtype=torch.float32, device=dev)
    Lr, Wr = L.clone(), W.clone()
    fullchol.diag_factor_inv(L, W, 1)
    fullchol.diag_factor_inv_reference(Lr, Wr, 1)
    Ljj = L[128:, 128:]
    assert _relerr(Ljj, Lr[128:, 128:]) < 1e-4 and _relerr(W[1], Wr[1]) < 1e-4
    assert torch.all(torch.triu(Ljj, 1) == 0) and torch.all(torch.triu(W[1], 1) == 0)
    assert float((W[1] @ Ljj - torch.eye(128, device=dev)).abs().max()) < 1e-4
    assert torch.equal(L[:128], Lr[:128]) and torch.all(W[0] == 0)


@pytest.mark.parametrize("where", [0, 31, 32, 127])  # the 32-block edges of K3
def test_diag_factor_inv_failed_pivot(dev, where):
    rng = np.random.default_rng(26)
    n = 384
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    A[128 + where, 128 + where] = -1e6  # panel 1
    L, W = fullchol._factor(_t(A, dev), n, (), fullchol._KERNEL_STEPS)
    assert not torch.isfinite(L[-1, -1])
    eye = torch.eye(128, device=dev)
    assert float((W[0] @ L[:128, :128] - eye).abs().max()) < 1e-4  # the panel before
    p = where  # the failed panel's leading rows are factored
    if p:
        Ljj = L[128:128 + p, 128:128 + p]
        assert float((W[1][:p, :p] @ Ljj - eye[:p, :p]).abs().max()) < 1e-4
    assert not torch.isfinite(W[1][p:, :p + 1]).all()
    assert torch.all(torch.triu(L, 1) == 0) and torch.all(torch.triu(W[1], 1) == 0)


def test_fit_routes_reach_the_kernels(dev):
    rng = np.random.default_rng(7)
    _cuda.reset_launch_counts()
    X = _t(rng.standard_normal((1100, 4)), dev)
    Y = _t(rng.standard_normal((1100, 2)), dev)
    k = tg.Gaussian(2.0, 1.0)
    routes = {
        "fused-gram": tg.fit(k, X[:600], Y[:600], 0.1, use_pallas_gram=True),
        "gram-kernel": tg.fit(k, X[:384], Y[:384], 0.1, use_pallas_gram=True),
        "fused-matrix": tg.fit(k, X[:1024], Y[:1024], 0.1, use_pallas_gram=False),
        "blocked-syrk": tg.fit(k, X, Y, 0.1, use_pallas_gram=False),
    }
    Xs = X[:16].cpu()
    for route, gp in routes.items():
        assert gp.route == route
        Xn, Yn = X[:gp.num_samples].cpu(), Y[:gp.num_samples].cpu()
        truth = tg.fit(k, Xn.double(), Yn.double(), float(np.float32(0.1))).predict(Xs.double())
        err_cpu = _relerr(tg.fit(k, Xn, Yn, 0.1).predict(Xs), truth)
        assert _relerr(gp.predict(X[:16]).cpu(), truth) <= 3 * err_cpu
    counts = _cuda.launch_counts()
    assert all(counts[name] > 0 for name in ("gram_tile", "panel_update", "diag_factor_inv",
                                              "panel_solve", "syrk_update"))


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
    # the kernel writes only the lower triangle: a NaN sentinel in the strict
    # upper (the upper tiles and the diagonal tiles' upper part) must survive
    r = torch.arange(m, device=dev)[:, None]
    c = torch.arange(m, device=dev)[None, :]
    upper_tiles = c > r
    A22[upper_tiles] = float("nan")
    out = syrk.syrk_update(A22, L21, out=A22)  # in place on a strided view
    assert out.data_ptr() == A22.data_ptr()
    assert bool(torch.isnan(A22[upper_tiles]).all())
    tl = r >= c
    assert float((A22 - expect)[tl].abs().max()) <= 1e-5 * float(expect.abs().max())
    assert torch.equal(W[:m0], top) and torch.equal(L21, left)  # nothing else written
    assert bool(torch.isfinite(A22[tl]).all()) and not torch.equal(A22[tl], before[tl])


@pytest.mark.parametrize("m,k", [(1, 0), (65, 33), (1853, 1920), (8191, 8192)])
def test_syrk_kernel_at_the_recursion_shapes(dev, m, k):
    # K5 in place on views of one buffer with the n=16383 recursion's row
    # stride (rows not 16-byte aligned): the lower triangle to 1e-5 sqrt(k)
    # of the largest entry against float64, the strict upper and the rest of
    # the buffer untouched
    n = 16383
    g = torch.Generator(device=dev).manual_seed(30)
    buf = torch.randn((n, n), generator=g, device=dev)
    buf[:, :k] /= max(k, 1) ** 0.5
    A22, L21 = buf[k:k + m, k:k + m], buf[k:k + m, :k]
    assert A22.stride(0) == L21.stride(0) == n
    r = torch.arange(m, device=dev)[:, None]
    c = torch.arange(m, device=dev)[None, :]
    A22[c > r] = float("nan")
    before = buf.clone()
    R = before[k:k + m, k:k + m].double() - L21.double() @ L21.double().T
    _cuda.reset_launch_counts()
    out = syrk.syrk_update(A22, L21, out=A22)
    assert out.data_ptr() == A22.data_ptr() and _cuda.launch_counts()["syrk_update"] == 1
    tl = r >= c
    err = float((A22.double() - R)[tl].abs().max() / R[tl].abs().max())
    assert err <= 1e-5 * max(1, k) ** 0.5
    assert bool(torch.isnan(A22[c > r]).all())
    buf[k:k + m, k:k + m][tl] = before[k:k + m, k:k + m][tl]
    assert torch.equal(buf.nan_to_num(7.0), before.nan_to_num(7.0))


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


@pytest.mark.parametrize("form", gop.FORMS)
def test_gram_batched_kernel(dev, form):
    rng = np.random.default_rng(12)
    X = _t(rng.standard_normal((3, 200, 37)), dev)  # ragged against the 64 tiles
    P = _t([[1.7, 1.2, 0.7 if form == "periodic" else 2.0, 0.37],
            [1.3, 0.9, 0.5 if form == "periodic" else 1.5, 0.1],
            [2.2, 1.4, 0.9 if form == "periodic" else 3.0, 0.01]], dev)
    _cuda.reset_launch_counts()
    K = gop.gram_batched(X, P, form=form)
    assert _cuda.launch_counts()["gram_batched"] == 1
    R = gop.gram_batched_reference(X, P, form=form)
    tol = (1e-2 if form == "matern12" else 3e-5) * (R.abs().max() if form == "sqdist" else 1.96)
    assert float((K - R).abs().max()) <= tol


@pytest.mark.parametrize("form", gop.FORMS)
@pytest.mark.parametrize("B", [1, 3, 128])
def test_gram_batched_kernel_shapes(dev, form, B):
    # ragged and whole 64-tiles, one tile to 16; each member's matrix exactly
    # symmetric (the kernel writes each lower tile twice, in place and mirrored)
    rng = np.random.default_rng(B)
    for n in (1, 63, 64, 65, 200, 512, 1024):
        X = _t(rng.standard_normal((B, n, 8)), dev)
        P = _t(np.stack([rng.uniform(1.0, 2.5, B), rng.uniform(0.8, 1.4, B),
                         rng.uniform(0.5, 0.9, B) if form == "periodic" else rng.uniform(1.0, 3.0, B),
                         rng.uniform(0.01, 0.4, B)], 1), dev)
        _cuda.reset_launch_counts()
        K = gop.gram_batched(X, P, form=form)
        assert _cuda.launch_counts()["gram_batched"] == 1
        assert torch.equal(K, K.mT), n
        R = gop.gram_batched_reference(X, P, form=form)
        # sqdist: of the larger of its largest entry and 2 max |x|^2 (at n = 1
        # the one entry is the diagonal, the plain version's a cancellation)
        big = max(float(R.abs().max()), 2.0 * float((X * X).sum(-1).max()))
        tol = (1e-2 if form == "matern12" else 3e-5) * (big if form == "sqdist" else 1.96)
        assert float((K - R).abs().max()) <= tol, n
        del K, R


def test_gram_batched_kernel_past_the_grid_z_limit(dev):
    # more members than gridDim.z allows: the launcher sends them in chunks
    rng = np.random.default_rng(17)
    B = 70000
    X = _t(rng.standard_normal((B, 16, 3)), dev)
    P = _t(np.stack([rng.uniform(0.5, 2.0, B), rng.uniform(0.5, 1.5, B),
                     np.ones(B), rng.uniform(0.01, 0.5, B)], 1), dev)
    _cuda.reset_launch_counts()
    K = gop.gram_batched(X, P)
    assert _cuda.launch_counts()["gram_batched"] == 1
    assert torch.equal(K, K.mT)
    assert float((K - gop.gram_batched_reference(X, P)).abs().max()) <= 3e-5 * 2.25


@pytest.mark.parametrize("b", [32, 33, 64, 128])
def test_crout_kernel_contracts(dev, b):
    rng = np.random.default_rng(13)
    G = rng.standard_normal((5, b, b))
    A = _t(G @ G.transpose(0, 2, 1) + b * np.eye(b), dev)
    A[3, 1, 1] = -1.0  # not positive definite
    junk = A.clone()
    junk[:, torch.triu(torch.ones((b, b), dtype=torch.bool, device=dev), 1)] = float("nan")
    _cuda.reset_launch_counts()
    L = crout.crout_chol(junk)  # reads the lower triangle only
    assert _cuda.launch_counts()["crout_chol"] == 1
    R = crout.crout_chol_reference(A)
    ok = [0, 1, 2, 4]
    assert _relerr(L[ok], R[ok]) <= 1e-5
    assert torch.all(torch.triu(L, 1) == 0) and torch.isfinite(L[ok]).all()
    assert torch.isnan(L[3, -1, -1]) and not torch.isfinite(R[3, -1, -1])


def test_crout_kernel_in_place_on_diagonal_blocks(dev):
    rng = np.random.default_rng(14)
    G = rng.standard_normal((2, 128, 128))
    S = _t(G @ G.transpose(0, 2, 1) + 128 * np.eye(128), dev)
    before = S.clone()
    D = S[:, 64:, 64:]
    out = crout.crout_chol(D, out=D)
    assert out.data_ptr() == D.data_ptr()
    assert _relerr(S[:, 64:, 64:], torch.linalg.cholesky(before[:, 64:, 64:])) <= 1e-5
    assert torch.equal(S[:, :64], before[:, :64]) and torch.equal(S[:, 64:, :64], before[:, 64:, :64])


@pytest.mark.parametrize("b", [1, 2, 5, 17, 31, 47, 63, 65, 95, 96, 97, 127])
def test_crout_kernel_every_width(dev, b):
    # the identity padding to a multiple of 32: junk (values and NaN) above
    # the diagonal never read, a failed pivot at the last real row poisons
    # L[-1, -1] of its tile only
    rng = np.random.default_rng(100 + b)
    A = _t(_spd_batch(rng, 4, b), dev)
    junk = A + torch.triu(_t(rng.standard_normal((4, b, b)), dev), 1)
    junk[1][torch.triu(torch.ones((b, b), dtype=torch.bool, device=dev), 1)] = float("nan")
    L = crout.crout_chol(junk)
    assert _relerr(L, crout.crout_chol_reference(A)) <= 1e-5
    assert torch.all(torch.triu(L, 1) == 0) and torch.isfinite(L).all()
    junk[2, -1, -1] = -1.0
    L2 = crout.crout_chol(junk)
    assert torch.isnan(L2[2, -1, -1]) and torch.equal(L2[[0, 1, 3]], L[[0, 1, 3]])
    assert torch.equal(L2[2, :-1], L[2, :-1])


def test_crout_kernel_in_place_on_a_fleet_buffer(dev):
    # the diagonal blocks of a (B, 512, 512) buffer at a panel step, in place:
    # one failed tile among finite ones; nothing outside the blocks written
    rng = np.random.default_rng(26)
    B, n, p = 6, 512, 128
    S = torch.full((B, n, n), 5.0, device=dev)
    S[:, 128:256, 128:256] = _t(_spd_batch(rng, B, p), dev)
    S[4, 128 + 70, 128 + 70] = -3.0  # not positive definite from its pivot 70 on
    before = S.clone()
    D = S[:, 128:256, 128:256]
    ref = crout.crout_chol_reference(before[:, 128:256, 128:256])
    _cuda.reset_launch_counts()
    assert crout.crout_chol(D, out=D).data_ptr() == D.data_ptr()
    assert _cuda.launch_counts()["crout_chol"] == 1
    ok = [0, 1, 2, 3, 5]
    assert _relerr(D[ok], ref[ok]) <= 1e-5 and torch.isfinite(D[ok]).all()
    assert torch.isnan(D[4, -1, -1]) and torch.isfinite(D[4, :70]).all()
    assert torch.all(torch.triu(D, 1) == 0)
    mask = torch.ones((n, n), dtype=torch.bool, device=dev)
    mask[128:256, 128:256] = False
    assert torch.equal(S[:, mask], before[:, mask])


@pytest.mark.parametrize("bs", [32, 64])
def test_fleet_diag_crout2_scheme_launches_k7(dev, monkeypatch, bs):
    # GPR_FLEET_DIAG=crout2<bs>: K7 on the (B, bs, bs) sub-blocks of every
    # 128-panel's diagonal block, batched GEMMs for the rest
    monkeypatch.setenv("GPR_FLEET_DIAG", f"crout2{bs}")
    rng = np.random.default_rng(27)
    B, n = 3, 256
    A = _t(_spd_batch(rng, B, n), dev)
    Y = _t(rng.standard_normal((B, n, 2)), dev)
    _cuda.reset_launch_counts()
    L, X = fleet_ops.factor_solve_batched_diff(A, Y)
    counts = _cuda.launch_counts()
    assert (counts["crout_chol"], counts["crout_chol_wi"]) == (n // bs, 0)
    assert _relerr(L.double(), torch.linalg.cholesky(A.double())) <= 1e-5
    assert _relerr(X.double(), torch.linalg.solve(A.double(), Y.double())) <= 1e-4


def test_fleet_routes_reach_the_kernels(dev):
    rng = np.random.default_rng(15)
    B, n, panel = 4, 256, fleet_ops.PANEL
    X = rng.standard_normal((B, n, 3))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((B, n, 2))
    Xs = rng.standard_normal((B, 16, 3))
    k = tg.Gaussian(1.5, 1.0)
    truth = fleet.fit_batched(k, X, Y, float(np.float32(0.1)), device="cpu")
    cpu32 = fleet.fit_batched(k, X.astype(np.float32), Y.astype(np.float32), 0.1, device="cpu")
    m64 = fleet.predict_batched(truth, Xs)
    err_cpu = _relerr(fleet.predict_batched(cpu32, Xs.astype(np.float32)), m64)
    _cuda.reset_launch_counts()
    gp = fleet.fit_batched(k, _t(X, dev), _t(Y, dev), 0.1)
    assert gp.route == "fleet-crout"
    assert _cuda.launch_counts() == {**{kk.name: 0 for kk in _cuda.KERNELS},
                                     "gram_batched": 1, "crout_chol": n // panel}
    assert torch.all(torch.triu(gp.L, 1) == 0)
    assert _relerr(fleet.predict_batched(gp, _t(Xs, dev)).cpu(), m64) <= 3 * err_cpu
    gp = fleet.fit_batched(k, _t(X[:, :250], dev), _t(Y[:, :250], dev), 0.1)
    assert gp.route == "torch-cholesky" and _cuda.launch_counts()["crout_chol"] == n // panel


def test_fleet_gradient_on_the_card(dev):
    rng = np.random.default_rng(16)
    B, n = 3, 128
    X = rng.standard_normal((B, n, 3))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((B, n, 2))

    def grad(Xa, Ya, **kw):
        p = torch.tensor([[1.2, 1.5, 2.0], [0.9, 1.0, 1.1]], dtype=torch.float64,
                         requires_grad=True)
        v = fleet.mll_batched(tg.Gaussian(p[0], p[1]), Xa, Ya, 0.1, batched_kernel=True, **kw)
        return torch.autograd.grad(v.sum(), p)[0].cpu()

    g64 = grad(X, Y, device="cpu")
    g32 = grad(X.astype(np.float32), Y.astype(np.float32), device="cpu")
    _cuda.reset_launch_counts()
    g = grad(_t(X, dev), _t(Y, dev))
    assert _cuda.launch_counts()["crout_chol"] == n // fleet_ops.PANEL  # none in the backward
    assert _relerr(g, g64) <= 3 * _relerr(g32, g64) + 1e-6


def _spd_batch(rng, B, b):
    G = rng.standard_normal((B, b, b))
    return G @ G.transpose(0, 2, 1) + b * np.eye(b)


@pytest.mark.parametrize("b", [32, 33, 64, 128])
def test_crout_wi_kernel_contracts(dev, b):
    rng = np.random.default_rng(18)
    A = _t(_spd_batch(rng, 5, b), dev)
    A[3, 1, 1] = -1.0  # not positive definite
    junk = A.clone()
    junk[:, torch.triu(torch.ones((b, b), dtype=torch.bool, device=dev), 1)] = float("nan")
    _cuda.reset_launch_counts()
    L, W = crout.crout_chol_wi(junk)  # reads the lower triangle only
    assert _cuda.launch_counts()["crout_chol_wi"] == 1
    R, RW = crout.crout_chol_wi_reference(A)
    ok = [0, 1, 2, 4]
    assert _relerr(L[ok], R[ok]) <= 1e-5 and _relerr(W[ok], RW[ok]) <= 1e-4
    eye = torch.eye(b, device=dev)
    assert float((W[ok] @ L[ok] - eye).abs().max()) <= 1e-4
    assert torch.all(torch.triu(L, 1) == 0) and torch.all(torch.triu(W, 1) == 0)
    assert torch.isfinite(L[ok]).all() and torch.isfinite(W[ok]).all()
    assert torch.isnan(L[3, -1, -1]) and torch.isnan(W[3, -1, -1])
    assert not torch.isfinite(R[3, -1, -1])


def test_crout_wi_kernel_in_place_on_strided_views(dev):
    rng = np.random.default_rng(19)
    S = _t(_spd_batch(rng, 2, 128), dev)
    before = S.clone()
    Wbuf = torch.full((2, 64, 80), 7.0, device=dev)
    D, Wv = S[:, 64:, 64:], Wbuf[:, :, 8:72]
    L, W = crout.crout_chol_wi(D, L_out=D, W_out=Wv)
    assert L.data_ptr() == D.data_ptr() and W.data_ptr() == Wv.data_ptr()
    ref = torch.linalg.cholesky(before[:, 64:, 64:].double())
    assert _relerr(S[:, 64:, 64:].double(), ref) <= 1e-5
    assert float((Wv.double() @ ref - torch.eye(64, device=dev, dtype=torch.float64)).abs().max()) <= 1e-4
    assert torch.equal(S[:, :64], before[:, :64]) and torch.equal(S[:, 64:, :64], before[:, 64:, :64])
    assert bool((Wbuf[:, :, :8] == 7.0).all() and (Wbuf[:, :, 72:] == 7.0).all())


def test_crout_wi_kernel_every_width_on_a_fleet_buffer(dev):
    # K8 at every b = 1-128 on the diagonal blocks of a (B, n, n) buffer, in
    # place (L over the blocks, W into its own strided view): junk and NaN
    # above the diagonal never read, one failed tile whose L[-1, -1] and
    # W[-1, -1] are NaN while the others stay bit-identical, nothing outside
    # the blocks written
    rng = np.random.default_rng(27)
    B = 4
    for b in range(1, 129):
        n = 2 * b + 3
        S = torch.full((B, n, n), 5.0, device=dev)
        A = _t(_spd_batch(rng, B, b), dev)
        S[:, b:2 * b, b:2 * b] = A + torch.triu(_t(rng.standard_normal((B, b, b)), dev), 1)
        S[1, b:2 * b, b:2 * b][torch.triu(torch.ones((b, b), dtype=torch.bool, device=dev), 1)] = float("nan")
        bad = S.clone()
        bad[2, 2 * b - 1, 2 * b - 1] = -1.0
        Wbuf = torch.full((B, b, b + 8), 7.0, device=dev)
        L, W = crout.crout_chol_wi(S[:, b:2 * b, b:2 * b], L_out=S[:, b:2 * b, b:2 * b], W_out=Wbuf[:, :, 4:4 + b])
        R, RW = crout.crout_chol_wi_reference(A)
        assert _relerr(L, R) <= 1e-5 and _relerr(W, RW) <= 1e-4, b
        assert torch.all(torch.triu(L, 1) == 0) and torch.all(torch.triu(W, 1) == 0)
        assert torch.isfinite(L).all() and torch.isfinite(W).all()
        assert bool((Wbuf[:, :, :4] == 7.0).all() and (Wbuf[:, :, 4 + b:] == 7.0).all())
        mask = torch.ones((n, n), dtype=torch.bool, device=dev)
        mask[b:2 * b, b:2 * b] = False
        assert bool((S[:, mask] == 5.0).all())
        Lb, Wb = crout.crout_chol_wi(bad[:, b:2 * b, b:2 * b])
        assert torch.isnan(Lb[2, -1, -1]) and torch.isnan(Wb[2, -1, -1])
        assert torch.equal(Lb[[0, 1, 3]], L[[0, 1, 3]]) and torch.equal(Wb[[0, 1, 3]], W[[0, 1, 3]])


@pytest.mark.parametrize("panel,q", [(16, 1), (32, 4), (64, 9), (128, 9)])
def test_fused_kernel_at_its_largest_n_every_panel(dev, panel, q):
    # n = 2048 (kFusedMaxN): the shared P tiles in paired groups at panels 32,
    # 64 and 128 (64 columns deep at a time), all resident at 16; q = 9 takes
    # two backward passes of 8; one member fails in its last panel
    n = fleet_ops.FUSED_MAX_N
    g = torch.Generator(device=dev).manual_seed(28 + panel)
    G = torch.randn((2, n, n), device=dev, generator=g)
    A = G @ G.mT / n + torch.eye(n, device=dev)
    A[1, n - 5, n - 5] = -1e4
    Y = torch.randn((2, n, q), device=dev, generator=g)
    L, X, W = fleet_ops.factor_solve_fused(A, Y, panel, return_winv=True)
    R, RX, RW = fleet_ops.factor_solve_fused_reference(A[:1], Y[:1], panel, return_winv=True)
    assert _relerr(L[:1], R) <= 1e-5 and _relerr(X[:1], RX) <= 1e-4 and _relerr(W[:1], RW) <= 1e-4
    truth = torch.linalg.solve(A[:1].double(), Y[:1].double())
    assert _relerr(X[:1].double(), truth) <= 1e-3
    assert torch.all(torch.triu(L, 1) == 0) and torch.isfinite(L[0]).all()
    assert torch.isnan(L[1, -1, -1]) and torch.isnan(X[1]).any()


@pytest.mark.parametrize("n,panel,q", [(128, 64, 1), (192, 64, 4), (384, 128, 4), (256, 32, 9)])
def test_fused_kernel_contracts(dev, n, panel, q):
    # n = 3 panel: every member's later panels depend on the earlier ones
    rng = np.random.default_rng(20)
    A = _t(_spd_batch(rng, 3, n), dev)
    A[1, n - 5, n - 5] = -1e4  # member 1 fails in its last panel
    Y = _t(rng.standard_normal((3, n, q)), dev)
    junk = A.clone()
    junk[:, torch.triu(torch.ones((n, n), dtype=torch.bool, device=dev), 1)] = float("nan")
    _cuda.reset_launch_counts()
    L, X = fleet_ops.factor_solve_fused(junk, Y, panel)  # reads the lower triangle only
    assert _cuda.launch_counts()["fleet_fused"] == 1
    R, RX = fleet_ops.factor_solve_fused_reference(A, Y, panel)
    ok = [0, 2]
    assert _relerr(L[ok], R[ok]) <= 1e-5 and _relerr(X[ok], RX[ok]) <= 1e-4
    truth = torch.linalg.solve(A[ok].double(), Y[ok].double())
    assert _relerr(X[ok].double(), truth) <= 1e-4
    assert torch.all(torch.triu(L, 1) == 0) and torch.isfinite(L[ok]).all()
    assert torch.isnan(L[1, -1, -1]) and torch.isnan(X[1]).any()
    assert not torch.isfinite(R[1, -1, -1])


def test_fused_kernel_at_its_largest_n(dev):
    rng = np.random.default_rng(21)
    n = fleet_ops.FUSED_MAX_N
    G = torch.randn((1, n, n), device=dev, generator=torch.Generator(device=dev).manual_seed(21))
    A = G @ G.mT / n + torch.eye(n, device=dev)
    Y = _t(rng.standard_normal((1, n, 2)), dev)
    L, X = fleet_ops.factor_solve_fused(A, Y, 128)
    truth = torch.linalg.solve(A.double(), Y.double())
    assert _relerr(X.double(), truth) <= 1e-3 and torch.all(torch.triu(L, 1) == 0)
    with pytest.raises(ValueError):
        fleet_ops.factor_solve_fused(torch.eye(n + 128, device=dev)[None],
                                     torch.zeros((1, n + 128, 1), device=dev), 128)


def test_fleet_fused_route_reaches_its_kernels(dev, monkeypatch):
    monkeypatch.setattr(fleet_ops, "_FLEET_FUSED_MAX_N", 1024)
    rng = np.random.default_rng(22)
    B, n = 4, 256
    X = rng.standard_normal((B, n, 3))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((B, n, 2))
    Xs = rng.standard_normal((B, 16, 3))
    k = tg.Gaussian(1.5, 1.0)
    m64 = fleet.predict_batched(fleet.fit_batched(k, X, Y, float(np.float32(0.1)), device="cpu"), Xs)
    cpu32 = fleet.fit_batched(k, X.astype(np.float32), Y.astype(np.float32), 0.1, device="cpu",
                              use_crout=False)
    err_cpu = _relerr(fleet.predict_batched(cpu32, Xs.astype(np.float32)), m64)
    _cuda.reset_launch_counts()
    gp = fleet.fit_batched(k, _t(X, dev), _t(Y, dev), 0.1)
    assert gp.route == "fleet-fused"
    assert _cuda.launch_counts() == {**{kk.name: 0 for kk in _cuda.KERNELS},
                                     "gram_batched": 1, "fleet_fused": 1}
    assert _relerr(fleet.predict_batched(gp, _t(Xs, dev)).cpu(), m64) <= 3 * err_cpu



def test_fleet_fused_gradient_on_the_card(dev, monkeypatch):
    # test_fleet_gradient_on_the_card's fleet and gate, on the fused route
    monkeypatch.setattr(fleet_ops, "_FLEET_FUSED_MAX_N", 1024)
    rng = np.random.default_rng(16)
    B, n = 3, 128
    X = rng.standard_normal((B, n, 3))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((B, n, 2))

    def grad(Xa, Ya, **kw):
        p = torch.tensor([[1.2, 1.5, 2.0], [0.9, 1.0, 1.1]], dtype=torch.float64,
                         requires_grad=True)
        v = fleet.mll_batched(tg.Gaussian(p[0], p[1]), Xa, Ya, 0.1, batched_kernel=True, **kw)
        return torch.autograd.grad(v.sum(), p)[0].cpu()

    g64 = grad(X, Y, device="cpu", use_crout=False)
    g32 = grad(X.astype(np.float32), Y.astype(np.float32), device="cpu", use_crout=False)
    _cuda.reset_launch_counts()
    g = grad(_t(X, dev), _t(Y, dev))
    # one K9 launch forward; the pullback's fleet solve: one K8 launch; no K7
    counts = _cuda.launch_counts()
    assert (counts["fleet_fused"], counts["crout_chol_wi"], counts["crout_chol"]) == (1, 1, 0)
    assert _relerr(g, g64) <= 3 * _relerr(g32, g64) + 1e-6


def test_fleet_diag_crout_scheme_launches_k8(dev, monkeypatch):
    monkeypatch.setenv("GPR_FLEET_DIAG", "crout")
    rng = np.random.default_rng(23)
    B, n = 3, 256
    A = _t(_spd_batch(rng, B, n), dev)
    Y = _t(rng.standard_normal((B, n, 2)), dev)
    _cuda.reset_launch_counts()
    L, X = fleet_ops.factor_solve_batched_diff(A, Y)
    counts = _cuda.launch_counts()
    assert (counts["crout_chol_wi"], counts["crout_chol"]) == (n // fleet_ops.PANEL, 0)
    assert _relerr(X.double(), torch.linalg.solve(A.double(), Y.double())) <= 1e-4
    assert _relerr(L.double(), torch.linalg.cholesky(A.double())) <= 1e-5


def test_cho_solve_without_inverses_launches_k8_once(dev):
    rng = np.random.default_rng(24)
    A = _t(_spd_batch(rng, 3, 384), dev)
    Y = _t(rng.standard_normal((3, 384, 2)), dev)
    L = fleet_ops.cholesky_batched(A)
    _cuda.reset_launch_counts()
    X = fleet_ops.cho_solve_batched(L, Y)
    assert _cuda.launch_counts()["crout_chol_wi"] == 1
    assert _relerr(X.double(), torch.linalg.solve(A.double(), Y.double())) <= 1e-4


def _narrow_system(rng, n, q, junk=True):
    # JAX's narrow-solve test system (tests/test_ops.py:630-634)
    X = rng.standard_normal((n, 64)).astype(np.float32)
    A = X @ X.T / 64 + 4.0 * np.eye(n, dtype=np.float32)
    Lh = np.linalg.cholesky(A).astype(np.float32)
    up = np.triu(rng.standard_normal((n, n)).astype(np.float32), 1) if junk else 0.0
    return Lh, Lh + up, rng.standard_normal((n, q)).astype(np.float32)


@pytest.mark.parametrize("n,q,bs", [(1024, 1, 512), (2048, 8, 512), (2048, 20, 512),
                                    (1024, 128, 512), (2048, 8, 1024), (1024, 3, 256),
                                    (1024, 16, 512), (4096, 1, 128), (4096, 3, 128), (4096, 8, 128),
                                    (4096, 16, 128), (4096, 128, 128)])
def test_narrow_subst_kernel(dev, n, q, bs):
    rng = np.random.default_rng(30)
    Lh, Lj, B = _narrow_system(rng, n, q)
    L, B = _t(Lj, dev), _t(B, dev)
    W = solve.diag_block_inverses(L, bs, "xla")
    _cuda.reset_launch_counts()
    Y = solve.subst_pass(L, W, B, True)
    X = solve.subst_pass(L, W, Y, False)
    assert _cuda.launch_counts()["narrow_subst"] == 2  # one persistent launch per sweep
    Yr = solve.subst_pass_reference(L, W, B, True)
    Xr = solve.subst_pass_reference(L, W, Y, False)
    assert _relerr(Y, Yr) <= 1e-5 and _relerr(X, Xr) <= 1e-5
    truth = torch.cholesky_solve(B.double(), torch.tensor(Lh, dtype=torch.float64, device=dev))
    assert _relerr(X.double(), truth) <= 2e-5


def test_narrow_subst_kernel_is_deterministic_and_poisoned_by_nan(dev):
    # one sweep a launch over 32 block rows: two calls bit-identical (every
    # sum in a fixed order, whatever CTA takes an item); a NaN in the strict
    # lower triangle of L, outside the diagonal tiles, makes both sweeps
    # non-finite from its block row on
    rng = np.random.default_rng(36)
    n, q, bs = 4096, 8, 128
    Lh, Lj, B = _narrow_system(rng, n, q)
    L, B = _t(Lj, dev), _t(B, dev)
    W = solve.diag_block_inverses(L, bs, "pallas")
    Y = solve.subst_pass(L, W, B, True)
    X = solve.subst_pass(L, W, Y, False)
    for _ in range(3):
        assert torch.equal(solve.subst_pass(L, W, B, True), Y)
        assert torch.equal(solve.subst_pass(L, W, Y, False), X)
    bad = L.clone()
    bad[20 * bs + 5, 3 * bs + 7] = float("nan")
    Yb = solve.subst_pass(bad, W, B, True)
    assert torch.isfinite(Yb[:20 * bs]).all() and not torch.isfinite(Yb[20 * bs:]).all()
    Xb = solve.subst_pass(bad, W, Y, False)
    assert not torch.isfinite(Xb[:4 * bs]).all() and torch.isfinite(Xb[4 * bs:]).all()


@pytest.mark.parametrize("diag_inv", ["xla", "pallas"])
@pytest.mark.parametrize("n,q,bs", [(2048, 8, 512), (1024, 1, 512), (1024, 128, 512), (3072, 8, 1024),
                                    (16384, 8, 512)])
def test_narrow_solve_at_jax_gate(dev, diag_inv, n, q, bs):
    # tests/test_ops.py:626-644's cases (seed 16, no junk), held at JAX's own
    # 5e-6 of the largest entry against a float64 solve of the same factor
    rng = np.random.default_rng(16)
    Lh, _, B = _narrow_system(rng, n, q, junk=False)
    _cuda.reset_launch_counts()
    X = solve.cho_solve_narrow(_t(Lh, dev), _t(B, dev), bs=bs, diag_inv=diag_inv)
    assert _cuda.launch_counts()["narrow_subst"] == 2
    truth = torch.cholesky_solve(torch.tensor(B, dtype=torch.float64, device=dev),
                                 torch.tensor(Lh, dtype=torch.float64, device=dev))
    assert _relerr(X.double(), truth) < 5e-6


@pytest.mark.parametrize("n,bs", [(1024, 256), (2048, 512), (512, 64)])
def test_diag_tri_inv_kernel(dev, n, bs):
    rng = np.random.default_rng(31)
    Lh, Lj, _ = _narrow_system(rng, n, 1)
    _cuda.reset_launch_counts()
    W = solve.diag_tri_inv(_t(Lj, dev), bs)  # reads the lower triangle only
    assert _cuda.launch_counts()["diag_tri_inv"] == 1
    R = solve.diag_tri_inv_reference(_t(Lh, dev), bs)
    assert _relerr(W, R) <= 1e-4 and torch.all(torch.triu(W, 1) == 0)
    D = solve._diag_tiles(_t(Lh, dev), bs)
    assert float((W @ D - torch.eye(bs, device=dev)).abs().max()) <= 1e-4
    bad = Lh.copy()
    bad[bs + 7, bs + 7] = float("nan")
    Wb = solve.diag_tri_inv(_t(bad, dev), bs)
    assert not bool(torch.isfinite(Wb[1]).all()) and bool(torch.isfinite(Wb[0]).all())


@pytest.mark.parametrize("bs", [16, 48, 256, 512])
def test_diag_tri_inv_blocked(dev, bs):
    # the blocked inverse at a ragged (16, 48) and full (256, 512) tile: NaN
    # and junk above the diagonal ignored, an exact-zero upper, and a NaN
    # pivot at 0, 31, 32, 511 (those inside the tile) and bs - 1 of tile 1
    # making that tile's W non-finite and no other
    rng = np.random.default_rng(35)
    n = 3 * bs
    Lh, Lj, _ = _narrow_system(rng, n, 1)
    R = solve.diag_tri_inv_reference(_t(Lh, dev), bs)
    for upper in (Lj, Lh + np.triu(np.full((n, n), np.nan, np.float32), 1)):
        _cuda.reset_launch_counts()
        W = solve.diag_tri_inv(_t(upper, dev), bs)
        torch.cuda.synchronize()
        assert _cuda.launch_counts()["diag_tri_inv"] == 1
        assert _relerr(W, R) <= 1e-4 and torch.all(torch.triu(W, 1) == 0)
    for p in sorted({0, 31, 32, 511, bs - 1} & set(range(bs))):
        bad = Lh.copy()
        bad[bs + p, bs + p] = np.nan
        Wb = solve.diag_tri_inv(_t(bad, dev), bs)
        assert [bool(torch.isfinite(Wb[i]).all()) for i in range(3)] == [True, False, True], p


@pytest.mark.parametrize("diag_inv", ["xla", "pallas"])
@pytest.mark.parametrize("n,q,bs", [(2048, 8, 512), (3072, 8, 1024), (1024, 1, 256)])
def test_cho_solve_narrow_on_the_card(dev, diag_inv, n, q, bs):
    rng = np.random.default_rng(32)
    Lh, Lj, B = _narrow_system(rng, n, q)
    _cuda.reset_launch_counts()
    b = _t(B[:, 0], dev) if q == 1 else _t(B, dev)
    X = solve.cho_solve_narrow(_t(Lj, dev), b, bs=bs, diag_inv=diag_inv)
    counts = _cuda.launch_counts()
    assert counts["narrow_subst"] == 2
    assert counts["diag_tri_inv"] == (1 if diag_inv == "pallas" else 0)
    assert X.shape == b.shape
    truth = torch.cholesky_solve(torch.tensor(B, dtype=torch.float64, device=dev),
                                 torch.tensor(Lh, dtype=torch.float64, device=dev))
    assert _relerr(X.double().reshape(truth.shape), truth) <= 2e-5
    bad = Lj.copy()
    bad[n - 3, 5] = float("nan")  # strictly lower: read by the sweeps
    assert not bool(torch.isfinite(solve.cho_solve_narrow(_t(bad, dev), b, bs=bs,
                                                          diag_inv=diag_inv)).all())


def test_narrow_routes_reach_the_kernels(dev, monkeypatch):
    monkeypatch.setenv("GPR_SOLVE_SCHEDULE", "narrow")
    monkeypatch.setenv("GPR_SOLVE_DIAGINV", "pallas")
    rng = np.random.default_rng(33)
    n = 1024
    X = rng.standard_normal((n, 3))
    Y = np.sin(X.sum(1, keepdims=True)) + 0.1 * rng.standard_normal((n, 2))
    k = tg.Gaussian(1.5, 1.0)
    _cuda.reset_launch_counts()
    gp = tg.fit(k, _t(X, dev), _t(Y, dev), 0.1, use_pallas_gram=False)
    assert gp.route == "fused-matrix" and linalg.solve_route(gp.L, gp.Y) == "narrow"
    counts = _cuda.launch_counts()
    assert counts["narrow_subst"] == 2 and counts["diag_tri_inv"] == 1
    truth = tg.fit(k, X, Y, float(np.float32(0.1)), device="cpu")
    cpu32 = tg.fit(k, X.astype(np.float32), Y.astype(np.float32), 0.1, device="cpu")
    assert _relerr(gp.alpha.cpu().double(), truth.alpha) <= 3 * _relerr(cpu32.alpha.double(), truth.alpha)
    _, g64 = lk.mll_value_and_grad(k, X, Y, 0.1, device="cpu")
    monkeypatch.setenv("GPR_SOLVE_SCHEDULE", "blocked")
    _, g32 = lk.mll_value_and_grad(k, X.astype(np.float32), Y.astype(np.float32), 0.1, device="cpu")
    monkeypatch.setenv("GPR_SOLVE_SCHEDULE", "narrow")
    _cuda.reset_launch_counts()
    _, g = lk.mll_value_and_grad(k, _t(X, dev), _t(Y, dev), 0.1)
    counts = _cuda.launch_counts()
    # one narrow solve forward, one in its backward
    assert counts["narrow_subst"] == 2 * 2 and counts["diag_tri_inv"] == 2
    assert _relerr(g.cpu(), g64) <= 3 * _relerr(g32, g64) + 1e-6


def test_sliding_window_on_the_card(dev, monkeypatch):
    monkeypatch.setenv("GPR_SOLVE_SCHEDULE", "narrow")
    rng = np.random.default_rng(34)
    n, k = 1024, 512
    X = rng.standard_normal((n + k, 5))
    Y = np.sin(X[:, :3]) + 0.1 * rng.standard_normal((n + k, 3))
    kern = tg.Gaussian(2.0, 1.0)
    _cuda.reset_launch_counts()
    gp = tg.fit(kern, _t(X[:n], dev), _t(Y[:n], dev), 0.1, use_pallas_gram=False)
    gp = tg.extend(gp, _t(X[n:], dev), _t(Y[n:], dev))
    gp = tg.shrink(gp, k)
    mean, var, lpd = exact.loo_cv(gp)
    assert _cuda.launch_counts()["narrow_subst"] == 2 * 3  # the solves at 1024, 1536 and 1024
    ref = tg.fit(kern, X[k:], Y[k:], float(np.float32(0.1)), device="cpu")
    cpu32 = tg.fit(kern, X[k:].astype(np.float32), Y[k:].astype(np.float32), 0.1, device="cpu")
    assert _relerr(gp.alpha.cpu().double(), ref.alpha) <= 3 * _relerr(cpu32.alpha.double(), ref.alpha)
    m64, _, _ = exact.loo_cv(ref)
    m32, _, _ = exact.loo_cv(cpu32)
    assert _relerr(mean.cpu().double(), m64) <= 3 * _relerr(m32.double(), m64)
    assert bool(torch.isfinite(var).all()) and bool(torch.isfinite(lpd))


@pytest.mark.parametrize("route", ["fleet-crout", "fleet-fused"])
def test_fleet_gradient_at_two_panels_on_the_card(dev, monkeypatch, route):
    # chip_tools/fused_backward_accuracy.py's B=4, n=256 fleet: fleet-crout
    # takes two panels of 128, fleet-fused four of 64
    monkeypatch.setattr(fleet_ops, "_FLEET_FUSED_MAX_N", 1024 if route == "fleet-fused" else 0)
    rng = np.random.default_rng(22)
    X = rng.standard_normal((4, 256, 3))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((4, 256, 2))

    def grad(Xa, Ya, **kw):
        p = torch.tensor([[1.2, 1.5, 2.0, 1.1], [0.9, 1.0, 1.1, 1.2]], dtype=torch.float64,
                         requires_grad=True)
        v = fleet.mll_batched(tg.Gaussian(p[0], p[1]), Xa, Ya, 0.1, batched_kernel=True, **kw)
        return torch.autograd.grad(v.sum(), p)[0].cpu()

    g64 = grad(X, Y, device="cpu", use_crout=False)
    g32 = grad(X.astype(np.float32), Y.astype(np.float32), device="cpu", use_crout=False)
    assert fleet.fleet_route(256, torch.float32, dev) == route
    g = grad(_t(X, dev), _t(Y, dev))
    assert _relerr(g, g64) <= 3 * _relerr(g32, g64) + 1e-6


def _leaf_spd(n, dev, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return _t(M @ M.T / n + np.eye(n), dev)


@pytest.mark.parametrize("n", [256, 512, 768, 1024])
def test_leaf_kernels(dev, n):
    A = _leaf_spd(n, dev, seed=n)
    # a strided view with NaN above the diagonal: only the lower triangle is read
    buf = torch.full((n + 64, n + 200), float("nan"), device=dev)
    view = buf[32:32 + n, 100:100 + n]
    view.copy_(torch.tril(A) + torch.triu(torch.full_like(A, float("nan")), 1))
    Lr, Wr = leaf.leaf_cholesky_wi_reference(A)
    _cuda.reset_launch_counts()
    L = leaf.leaf_cholesky(view)
    Lw, W = leaf.leaf_cholesky_wi(view)
    Wt = leaf.tri_inv_leaf(Lw + torch.triu(torch.full_like(A, float("nan")), 1))
    torch.cuda.synchronize()
    c = _cuda.launch_counts()
    assert c["leaf_chol"] == 1 and c["leaf_chol_wi"] == 1 and c["tri_inv_leaf"] == 1
    eye = torch.eye(n, device=dev)
    for M, R in ((L, Lr), (Lw, Lr), (W, Wr), (Wt, leaf.tri_inv_leaf_reference(Lw))):
        assert bool(torch.all(torch.triu(M, 1) == 0)) and _relerr(M, R) <= 1e-5
    assert torch.equal(Lw, L)  # K13's factor is K12's kernel
    assert float((W @ Lw - eye).abs().max()) < 1e-4 and float((Wt @ Lw - eye).abs().max()) < 1e-4
    assert bool(torch.isnan(buf[:32]).all())  # the out-of-place calls leave the input alone
    assert torch.equal(leaf.leaf_cholesky(view), L)  # fixed sum order: two calls bit-equal
    saved = view.clone()
    Lk = leaf.leaf_cholesky(view, out=view)  # K12 in place: each CTA reads and writes its own rows
    assert Lk.data_ptr() == view.data_ptr() and torch.equal(view, L)
    view.copy_(saved)
    Lv, Wv = leaf.leaf_cholesky_wi(view, out=view)  # in place, as the recursion factors
    assert Lv.data_ptr() == view.data_ptr() and _relerr(view, Lr) <= 1e-5 and _relerr(Wv, Wr) <= 1e-5


@pytest.mark.parametrize("n", [256, 512, 768, 1024])
def test_tri_inv_leaf_kernel(dev, n):
    # K14 on a strided view with NaN above the diagonal and all around it
    Lr = torch.linalg.cholesky(_leaf_spd(n, dev, seed=n + 1).double()).float().contiguous()
    buf = torch.full((n + 64, n + 200), float("nan"), device=dev)
    view = buf[32:32 + n, 100:100 + n]
    view.copy_(Lr + torch.triu(torch.full_like(Lr, float("nan")), 1))
    _cuda.reset_launch_counts()
    W = leaf.tri_inv_leaf(view)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["tri_inv_leaf"] == 1  # one counted launch a call
    assert bool(torch.all(torch.triu(W, 1) == 0)) and _relerr(W, leaf.tri_inv_leaf_reference(Lr)) <= 1e-5
    assert float((W @ Lr - torch.eye(n, device=dev)).abs().max()) < 1e-4
    assert torch.equal(leaf.tri_inv_leaf(Lr), W)  # only the lower triangle is read
    assert torch.equal(leaf.tri_inv_leaf(view), W)  # fixed sum order, and the flags came back zero
    assert not bool(leaf._flags(dev).any()) and bool(torch.isnan(buf[:32]).all())
    L13, W13 = leaf.leaf_cholesky_wi(_leaf_spd(n, dev, seed=n + 2))
    assert torch.equal(leaf.tri_inv_leaf(L13), W13)  # K13's inverse is K14's launch


@pytest.mark.parametrize("where,pivot", [(0, 0.0), (511, float("nan")), (1023, 0.0)])
def test_tri_inv_leaf_failed_pivot(dev, where, pivot):
    L = torch.linalg.cholesky(_leaf_spd(1024, dev, seed=5).double()).float().contiguous()
    L[where, where] = pivot
    W = leaf.tri_inv_leaf(L)
    assert not bool(torch.isfinite(W).all()) and bool(torch.all(torch.triu(W, 1) == 0))
    assert not bool(leaf._flags(dev).any())


def test_leaf_kernels_poison_a_failed_leaf(dev):
    A = _leaf_spd(1024, dev, seed=3)
    A[600, 600] = -1.0
    L, W = leaf.leaf_cholesky_wi(A)
    assert bool(torch.isnan(L[-1, -1])) and not bool(torch.isfinite(W).all())
    assert bool(torch.isnan(leaf.leaf_cholesky(A)[-1, -1]))
    assert bool(torch.all(torch.triu(L, 1) == 0)) and bool(torch.all(torch.triu(W, 1) == 0))


@pytest.mark.parametrize("where", [31, 32, 512, 1023])
def test_leaf_chol_failed_pivot_at_block_edges(dev, where):
    # K12's 32-wide diagonal blocks: a pivot that fails at the end or the
    # start of one, or at the last pivot, leaves the rows before it finite and
    # poisons every row from it on, L[-1, -1] included
    A = _leaf_spd(1024, dev, seed=4)
    A[where, where] = -1.0
    L = leaf.leaf_cholesky(A)
    rows_ok = torch.isfinite(L).all(dim=1)
    assert bool(rows_ok[:where].all()) and not bool(rows_ok[where:].any())
    assert bool(torch.isnan(L[-1, -1])) and bool(torch.all(torch.triu(L, 1) == 0))
    e = where // leaf.BLOCK * leaf.BLOCK  # the plain version's 64-block fails whole
    if e:
        assert _relerr(L[:e], leaf.leaf_cholesky_reference(A)[:e]) <= 1e-5


@pytest.mark.parametrize("n,leaves", [(2048, 2), (3773, 2)])
def test_blocked_leaf_route_launches_k13(dev, monkeypatch, n, leaves):
    monkeypatch.setenv("GPR_CHOL_SCHEDULE", "recursive")
    monkeypatch.setenv("GPR_CHOL_LEAF_INV", "1")
    A = _leaf_spd(n, dev, seed=n)
    assert linalg.cholesky_route(A) == "blocked-syrk-leaf"
    _cuda.reset_launch_counts()
    L, jit = linalg.safe_cholesky(A)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["leaf_chol_wi"] == leaves and float(jit) == 0.0
    ref = torch.linalg.cholesky(A.double())
    assert _relerr(L.double(), ref) <= 1e-4 and bool(torch.all(torch.triu(L, 1) == 0))
    monkeypatch.setenv("GPR_CHOL_LEAF_INV", "0")
    _cuda.reset_launch_counts()
    L0, _ = linalg.safe_cholesky(A)
    assert _cuda.launch_counts()["leaf_chol_wi"] == 0 and _relerr(L, L0) <= 1e-4


def _spd_f32(n, dev, seed):
    G = np.random.default_rng(seed).standard_normal((n, n))
    return _t(G @ G.T + n * np.eye(n), dev)


def test_rank_update_tiles_kernel(dev):
    # JAX's lists (tests/test_ops.py:805-823), then the schedule's narrow and
    # wide lists at n = 2048; the whole target tile, nothing else written
    S0 = _t(np.random.default_rng(1).standard_normal((2048, 2048)), dev)
    steps = [([2, 3, 3], [2, 2, 3], [0, 1], 256)]
    steps += [(r.tolist(), c.tolist(), k.tolist(), bm)
              for _, r, c, k, bm in (s_ for s_ in inplace_chol.schedule(2048, 512, 256, dev)
                                     if s_[0] == "update")][:2]
    assert [st[3] for st in steps] == [256, 256, 512]
    for rows, cols, kcols, bm in steps:
        S, R = S0.clone(), S0.clone()
        _cuda.reset_launch_counts()
        out = inplace_chol.rank_update_inplace(S, rows, cols, kcols, bm=bm, bk=bm)
        torch.cuda.synchronize()
        assert out is S and _cuda.launch_counts()["rank_update_tiles"] == 1
        inplace_chol.rank_update_reference(R, rows, cols, kcols, bm=bm, bk=bm)
        assert float((S - R).abs().max()) <= 1e-5 * float(R.abs().max())
        mask = torch.ones_like(S, dtype=torch.bool)
        for i, j in zip(rows, cols):
            mask[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm] = False
        assert torch.equal(S[mask], S0[mask]) and not torch.equal(S[~mask], S0[~mask])


def test_rank_update_tiles_smallest_grids(dev):
    # the last narrow (one 256-tile: 4 blocks) and wide (one 512-tile: 16
    # blocks) calls of the n = 16384 schedule: 1e-5 of the largest entry,
    # nothing outside the target written, two calls bit-identical
    n = 16384
    steps = [s_ for s_ in inplace_chol.schedule(n, 512, 256, dev) if s_[0] == "update"]
    last = {s_[4]: s_ for s_ in steps}
    g = torch.Generator(device=dev).manual_seed(36)
    S0 = torch.randn((n, n), generator=g, device=dev)
    for bm in (256, 512):
        _, rows, cols, kcols, _ = last[bm]
        assert rows.numel() == 1
        S, R = S0.clone(), S0.clone()
        _cuda.reset_launch_counts()
        inplace_chol._rank_update_tiles(S, rows, cols, kcols, bm, bm)
        torch.cuda.synchronize()
        assert _cuda.launch_counts()["rank_update_tiles"] == 1
        inplace_chol.rank_update_reference(R, rows, cols, kcols, bm=bm, bk=bm)
        assert float((S - R).abs().max()) <= 1e-5 * float(R.abs().max())
        i, j = int(rows[0]), int(cols[0])
        changed = S != S0
        changed[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm] = False
        assert not bool(changed.any())
        S2 = S0.clone()
        inplace_chol._rank_update_tiles(S2, rows, cols, kcols, bm, bm)
        assert torch.equal(S, S2)
        del S, R, S2, changed
    del S0
    torch.cuda.empty_cache()


def test_rank_update_tiles_deterministic(dev):
    # the first wide call at n = 2048 twice on one input: bit-identical
    S0 = _t(np.random.default_rng(37).standard_normal((2048, 2048)), dev)
    _, rows, cols, kcols, bm = [s_ for s_ in inplace_chol.schedule(2048, 512, 256, dev)
                                if s_[0] == "update"][1]
    outs = []
    for _ in range(2):
        S = S0.clone()
        inplace_chol._rank_update_tiles(S, rows, cols, kcols, bm, bm)
        outs.append(S)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], S0)


def test_rank_update_checks_device_lists(dev):
    # int32 lists already on the card are checked too: out of range or of
    # two lengths raise before any launch, and S is left as it was
    S = torch.ones((512, 512), device=dev)
    for rows, cols, kcols in (([2], [0], [0]), ([1], [0], [2]), ([1, 1], [0], [0])):
        args = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (rows, cols, kcols)]
        _cuda.reset_launch_counts()
        with pytest.raises(ValueError, match="coordinates|one length"):
            inplace_chol.rank_update_inplace(S, *args, bm=256, bk=256)
        assert _cuda.launch_counts()["rank_update_tiles"] == 0
    assert bool(torch.all(S == 1))


@pytest.mark.parametrize("c0t", [0, 2, 3])
def test_panel_inplace_kernel(dev, c0t):
    A = _spd_f32(1024, dev, seed=c0t)
    e = (c0t + 1) * 256
    S = A.clone()
    S[c0t * 256:e, c0t * 256:e] += torch.triu(torch.full((256, 256), float("nan"), device=dev), 1)
    R = inplace_chol.panel_inplace_reference(A.clone(), c0t)
    _cuda.reset_launch_counts()
    inplace_chol.panel_inplace(S, c0t)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["panel_inplace"] == 1
    panel_ = (slice(c0t * 256, None), slice(c0t * 256, e))
    assert _relerr(S[panel_], R[panel_]) <= 1e-5
    assert bool(torch.all(torch.triu(S[c0t * 256:e, c0t * 256:e], 1) == 0))
    mask = torch.ones_like(S, dtype=torch.bool)
    mask[panel_] = False
    assert torch.equal(S[mask], A[mask])  # only the panel is rewritten


@pytest.mark.parametrize("c0t", [0, 7, 15])
def test_panel_inplace_kernel_junk_and_failed_pivot(dev, c0t):
    # K17 on the n = 4096 schedule's first, a middle and its last panel: junk
    # (NaN, 1234.0) above the diagonal tile leaves S bit-identical, a second
    # call is bit-equal, and a failed pivot in the tile reaches its last
    # pivot and every row below
    n, e = 4096, (c0t + 1) * 256
    A = _spd_f32(n, dev, seed=40 + c0t)
    R = inplace_chol.panel_inplace_reference(A.clone(), c0t)
    outs = []
    for junk in (float("nan"), 1234.0, float("nan")):
        S = A.clone()
        S[c0t * 256:e, c0t * 256:e] += torch.triu(torch.full((256, 256), junk, device=dev), 1)
        outs.append(inplace_chol.panel_inplace(S, c0t))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    panel_ = (slice(c0t * 256, None), slice(c0t * 256, e))
    assert _relerr(outs[0][panel_], R[panel_]) <= 1e-5
    bad = A.clone()
    bad[c0t * 256 + 100, c0t * 256 + 100] = -1.0
    inplace_chol.panel_inplace(bad, c0t)
    assert bool(torch.isnan(bad[e - 1, e - 1])) and not bool(torch.isfinite(bad[e:, c0t * 256:e]).all(dim=1).any())


def test_zero_upper_kernel(dev):
    S = _t(np.random.default_rng(2).standard_normal((1536, 1536)), dev)
    S += torch.triu(torch.full_like(S, float("nan")), 1)
    expect = torch.tril(S)
    _cuda.reset_launch_counts()
    inplace_chol.zero_upper_inplace(S)
    assert _cuda.launch_counts()["zero_upper"] == 1 and torch.equal(S, expect)


@pytest.mark.parametrize("n", [256, 1024, 8192])
def test_panel_factor_kernel(dev, n):
    if n <= 1024:
        A = _spd_f32(1024, dev, seed=n)
    else:  # G G^T + n I made on the card
        G = torch.randn((n, n), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
        A = G @ G.T
        A.diagonal().add_(n)
    P = A[:n, :256]  # a strided view: row stride max(n, 1024)
    _cuda.reset_launch_counts()
    L = panel.panel_factor(P)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["panel_factor"] == 1 and L.shape == (n, 256)
    assert _relerr(L, panel.panel_factor_reference(P)) <= 1e-5
    assert bool(torch.all(torch.triu(L[:256], 1) == 0))
    assert torch.equal(panel.panel_factor(P), L)  # fixed sum order: two calls bit-equal
    Pn = P.clone()
    Pn[:256] += torch.tril(torch.full((256, 256), float("nan"), device=dev), -1)
    assert torch.equal(panel.panel_factor(Pn), L)  # D is read from its upper triangle only
    with pytest.raises(ValueError, match="must be"):
        panel.panel_factor(A[:1000, :256])
    ref = torch.linalg.cholesky(A.double())
    for fn in (panel.cholesky_panels, panel.cholesky_left_panels):
        assert _relerr(fn(A).double(), ref) <= 1e-5


@pytest.mark.parametrize("n", [1024, 2048])
def test_cholesky_inplace_kernels(dev, n):
    A = _spd_f32(n, dev, seed=n)
    _cuda.reset_launch_counts()
    L = inplace_chol.cholesky_inplace(A)
    torch.cuda.synchronize()
    c = _cuda.launch_counts()
    assert (c["panel_inplace"], c["rank_update_tiles"], c["zero_upper"]) == (n // 256, n // 256 - 1, 1)
    assert _relerr(L.double(), torch.linalg.cholesky(A.double())) <= 1e-5
    assert bool(torch.all(torch.triu(L, 1) == 0))
    assert _relerr(L, inplace_chol.cholesky_inplace(A.cpu()).to(dev)) <= 1e-5
    for junk in (float("nan"), 1234.0):  # reads the lower triangle only
        J = torch.tril(A) + torch.triu(torch.full_like(A, junk), 1)
        assert torch.equal(inplace_chol.cholesky_inplace(J), L)


def test_inplace_route_on_the_card(dev, monkeypatch):
    monkeypatch.setenv("GPR_CHOL_SCHEDULE", "inplace")
    A = _spd_f32(1024, dev, seed=5)
    assert linalg.cholesky_route(A) == "inplace"
    _cuda.reset_launch_counts()
    L, jit = linalg.safe_cholesky(A)
    torch.cuda.synchronize()
    c = _cuda.launch_counts()
    assert float(jit) == 0.0 and (c["panel_inplace"], c["rank_update_tiles"], c["zero_upper"]) == (4, 3, 1)
    assert c["panel_update"] == 0 and c["syrk_update"] == 0 and c["leaf_chol_wi"] == 0
    bad = A.clone()
    bad[700, 700] = -bad[700, 700]
    assert bool(torch.isnan(inplace_chol.cholesky_inplace(bad)[-1, -1]))
    Lb, jb = linalg.safe_cholesky(torch.zeros((1024, 1024), device=dev))
    assert float(jb) > 0.0 and bool(torch.isfinite(Lb).all())


def _recon(L, A):
    L, A = L.double(), A.double()
    return float(torch.linalg.norm(L @ L.mT - A) / torch.linalg.norm(A))


@pytest.mark.parametrize("n", [64, 256, 512])
def test_tile_chol_kernels(dev, n):
    A = _leaf_spd(n, dev, seed=n)
    A_nan = torch.triu(A) + torch.tril(torch.full_like(A, float("nan")), -1)
    _cuda.reset_launch_counts()
    runs = [(chol.cholesky_tile, chol.cholesky_tile_reference, {})]
    runs += [(chol.cholesky_tile_v2, chol.cholesky_tile_v2_reference, {"sw": sw}) for sw in (8, 16)]
    for fn, ref, kw in runs:
        L = fn(A, **kw)
        assert torch.equal(fn(A_nan, **kw), L)  # only the upper triangle is read
        assert bool(torch.all(torch.triu(L, 1) == 0))
        assert _relerr(L, ref(A, **kw)) <= 1e-5 and _recon(L, A) < 1e-5
    torch.cuda.synchronize()
    c = _cuda.launch_counts()
    assert c["tile_chol"] == 2 and c["tile_chol_strips"] == 4


@pytest.mark.parametrize("where", [3, 200])
def test_tile_chol_failed_pivot(dev, where):
    A = _leaf_spd(256, dev, seed=4)
    A[where, where] = -1.0
    for L in (chol.cholesky_tile(A), chol.cholesky_tile_v2(A, sw=8), chol.cholesky_tile_v2(A, sw=16)):
        rows_ok = torch.isfinite(L).all(dim=1)
        assert bool(rows_ok[:where].all()) and not bool(rows_ok[where:].any())
        assert bool(torch.isnan(L[-1, -1])) and bool(torch.all(torch.triu(L, 1) == 0))


def test_leaf_cholesky_dispatch(dev):
    A = _leaf_spd(513, dev, seed=5)
    _cuda.reset_launch_counts()
    L = chol.leaf_cholesky(A[:512, :512])
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["tile_chol"] == 1
    assert torch.equal(L, chol.cholesky_tile(A[:512, :512]))
    _cuda.reset_launch_counts()
    for M in (A, A[:512, :512].double(), A[:512, :512].cpu()):
        R = chol.leaf_cholesky(M)
        assert _relerr(R.to(dev).float(), torch.linalg.cholesky(M.double()).to(dev)) <= 1e-4
    torch.cuda.synchronize()
    assert _cuda.launch_counts() == {k.name: 0 for k in _cuda.KERNELS}


@pytest.mark.parametrize("n", [1, 33, 200])
def test_tile_chol_unaligned(dev, n):
    # the partial last 32-block is masked inside the kernel
    A = _leaf_spd(n, dev, seed=n)
    A_nan = torch.triu(A) + torch.tril(torch.full_like(A, float("nan")), -1)
    runs = [(chol.cholesky_tile, chol.cholesky_tile_reference, {})]
    runs += [(chol.cholesky_tile_v2, chol.cholesky_tile_v2_reference, {"sw": sw}) for sw in (8, 16) if n % sw == 0]
    for fn, ref, kw in runs:
        L = fn(A, **kw)
        assert torch.equal(fn(A_nan, **kw), L)
        assert bool(torch.all(torch.triu(L, 1) == 0))
        assert _relerr(L, ref(A, **kw)) <= 1e-5 and _recon(L, A) < 1e-5


@pytest.mark.parametrize("n,where", [(256, 32), (256, 64), (200, 199)])
def test_tile_chol_failed_pivot_at_block_edges(dev, n, where):
    # the first pivot of a diagonal block, and the last of a partial one
    A = _leaf_spd(n, dev, seed=8)
    A[where, where] = -1.0
    fns = [chol.cholesky_tile] + [lambda M, sw=sw: chol.cholesky_tile_v2(M, sw=sw) for sw in (8, 16) if n % sw == 0]
    for fn in fns:
        L = fn(A)
        rows_ok = torch.isfinite(L).all(dim=1)
        assert bool(rows_ok[:where].all()) and not bool(rows_ok[where:].any())
        assert bool(torch.isnan(L[-1, -1])) and bool(torch.all(torch.triu(L, 1) == 0))


@pytest.mark.parametrize("n", [200, 512])
def test_tile_chol_is_deterministic(dev, n):
    A = _leaf_spd(n, dev, seed=9)
    assert torch.equal(chol.cholesky_tile(A), chol.cholesky_tile(A))
    for sw in (8, 16):
        if n % sw == 0:
            assert torch.equal(chol.cholesky_tile_v2(A, sw=sw), chol.cholesky_tile_v2(A, sw=sw))


def test_tile_chol_refuses_what_the_kernel_does_not_take(dev):
    A = _leaf_spd(200, dev, seed=6)
    for call in (lambda: chol.cholesky_tile_v2(A, sw=16),  # 16 does not divide 200
                 lambda: chol.cholesky_tile_v2(A, sw=4),  # no 4-wide strips on the card
                 lambda: chol.cholesky_tile(A.double()),
                 lambda: chol.cholesky_tile(_leaf_spd(513, dev, seed=7))):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# the samplers on the fleet route (inference/hmc.py, nuts.py)
# ---------------------------------------------------------------------------

def _sampler_data(n=256, seed=30):
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 10, n)[:, None]
    return X, np.sin(X) + 0.1 * rng.standard_normal((n, 1))


def test_log_posterior_route_and_launches_on_the_card(dev):
    from gpr_tpu_torch.inference import hmc

    X, Y = _sampler_data()
    z = np.random.default_rng(31).uniform(-1, 1, (4, 2))
    k = tg.Gaussian(1.0, 1.0)
    f64 = hmc._value_and_grad(hmc.make_gp_log_posterior(k, X, Y, 0.1, device="cpu"))
    f32 = hmc._value_and_grad(hmc.make_gp_log_posterior(k, X.astype(np.float32),
                                                        Y.astype(np.float32), 0.1, device="cpu"))
    lp = hmc.make_gp_log_posterior(k, _t(X, dev), _t(Y, dev), 0.1)
    assert lp.route == "fleet-crout"
    v64, g64 = f64(torch.tensor(z))
    v32, g32 = f32(torch.tensor(z, dtype=torch.float32))
    _cuda.reset_launch_counts()
    v, g = hmc._value_and_grad(lp)(_t(z, dev))
    # one factorization in the forward, none in the backward
    assert _cuda.launch_counts()["crout_chol"] == 256 // fleet_ops.PANEL
    assert _relerr(v.cpu().double(), v64) <= 3 * _relerr(v32.double(), v64) + 1e-7
    assert _relerr(g.cpu().double(), g64) <= 3 * _relerr(g32.double(), g64) + 1e-6


def test_safe_fleet_factor_retries_on_the_card(dev):
    rng = np.random.default_rng(32)
    B, n = 3, 256
    K = np.stack([_spd_batch(rng, 1, n)[0] / n for _ in range(B)])
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(0.1, 1.0, n)
    lam[0] = -3e-3  # float32 eps * 10^k first passes it at k = 5, far from rounding
    K[1] = (Q * lam) @ Q.T
    Y = rng.standard_normal((B, n, 2))
    Kt = _t(K, dev).requires_grad_()
    _cuda.reset_launch_counts()
    L, alpha, jitter = fleet_ops.factor_solve_safe(Kt, _t(Y, dev), "fleet-crout")
    # the first attempt on all three, six retries of member 1 alone (eps * 10^k, k = 0..5)
    assert _cuda.launch_counts()["crout_chol"] == 7 * n // fleet_ops.PANEL
    eps = float(torch.finfo(torch.float32).eps)
    assert jitter.tolist() == [0.0, pytest.approx(eps * 1e5, rel=1e-6), 0.0]
    L0 = fleet_ops.cholesky_batched(Kt.detach())
    assert torch.equal(L[[0, 2]], L0[[0, 2]])
    truth = np.linalg.solve(K + jitter.cpu().double().numpy()[:, None, None] * np.eye(n), Y)
    assert _relerr(alpha.detach().cpu().double(), torch.tensor(truth)) < 1e-2
    (gK,) = torch.autograd.grad(alpha.sum() + torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(), Kt)
    assert torch.isfinite(gK).all()


def test_hmc_transition_on_the_card_matches_the_cpu(dev):
    from gpr_tpu_torch.inference import hmc

    X, Y = _sampler_data()
    k = tg.Gaussian(1.0, 1.0)
    z0 = np.random.default_rng(33).uniform(-0.3, 0.3, (4, 2)).astype(np.float32)
    cfg = hmc.HMCConfig(num_leapfrog=4)
    out = {}
    for where in ("cpu", dev):
        lp = hmc.make_gp_log_posterior(k, X.astype(np.float32), Y.astype(np.float32), 0.1,
                                       use_crout=True, device=where)
        st = hmc.init_chains(lp, torch.tensor(z0, device=where))
        g = torch.Generator().manual_seed(0)
        draws = hmc._hmc_draws(g, hmc.ChainState(*(t.cpu() for t in st)), cfg)
        draws = hmc.HMCDraws(*(t.to(where) for t in draws))
        _cuda.reset_launch_counts()
        s1, acc = hmc._hmc_step(hmc._value_and_grad(lp), st, draws,
                                torch.tensor(0.02, device=where), torch.ones(2, device=where), cfg)
        out[str(where)] = (s1, acc, draws.u, _cuda.launch_counts()["crout_chol"])
    (sc, ac, u, kc), (sg, ag, _, kg) = out["cpu"], out[str(dev)]
    assert kc == 0 and kg == int(draws.n_steps.max()) * 256 // fleet_ops.PANEL
    # both float32: the log posteriors (~1e2) differ by ~1e-3, and so do
    # the log accept ratios
    assert (ag.cpu() - ac).abs().max() < 1e-2
    same = (u - ac).abs() > 2e-2  # decisions far from the uniform agree
    assert same.any()
    assert torch.allclose(sg.z.cpu()[same], sc.z[same], rtol=1e-4, atol=1e-5)


def test_nuts_transition_on_the_card_matches_the_cpu(dev):
    from gpr_tpu_torch.inference import hmc, nuts

    mu = np.array([0.5, -1.0, 2.0])
    sd = np.array([0.7, 1.2, 0.4])

    def target(where):
        m, s = torch.tensor(mu, device=where), torch.tensor(sd, device=where)
        return lambda z: -0.5 * (((z - m) / s) ** 2).sum(-1)

    cfg = nuts.NUTSConfig(max_depth=6)
    z0 = np.random.default_rng(34).standard_normal((5, 3))
    g = torch.Generator().manual_seed(1)
    draws = nuts._nuts_draws(g, hmc.ChainState(torch.tensor(z0), torch.zeros(5),
                                               torch.zeros(5, 3)), cfg)
    out = []
    for where in ("cpu", dev):
        f = target(where)
        st = hmc.init_chains(f, torch.tensor(z0, device=where))
        s1, acc = nuts._nuts_step(hmc._value_and_grad(f), st, nuts.NUTSDraws(*(t.to(where) for t in draws)),
                                  torch.tensor(0.3, dtype=torch.float64, device=where),
                                  torch.ones(3, dtype=torch.float64, device=where), cfg)
        out.append((s1.z.cpu(), acc.cpu()))
    assert torch.allclose(out[0][0], out[1][0], rtol=1e-10, atol=1e-12)
    assert torch.allclose(out[0][1], out[1][1], rtol=1e-10, atol=1e-12)
    # and on the fleet route: every leaf one factorization of n / 128 K7 launches
    X, Y = _sampler_data()
    lp = hmc.make_gp_log_posterior(tg.Gaussian(1.0, 1.0), _t(X, dev), _t(Y, dev), 0.1)
    st = hmc.init_chains(lp, _t(np.zeros((4, 2)), dev))
    _cuda.reset_launch_counts()
    s1, acc = nuts._nuts_transition(hmc._value_and_grad(lp), st, torch.Generator(dev).manual_seed(2),
                                    torch.tensor(0.02, device=dev), torch.ones(2, device=dev),
                                    nuts.NUTSConfig(max_depth=4))
    launches = _cuda.launch_counts()["crout_chol"]
    assert launches > 0 and launches % (256 // fleet_ops.PANEL) == 0
    assert torch.isfinite(s1.z).all() and ((acc >= 0) & (acc <= 1)).all()


# ---------------------------------------------------------------------------
# the sparse GP (gp/sparse.py) and its log posterior (inference/hmc.py)
# ---------------------------------------------------------------------------

def _sparse_data(n, m, d=8, q=4):
    # benchmarks/bench_sparse.py's recipe at a smaller n
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d))
    return X, rng.standard_normal((n, q)), X[:: n // m][:m]


def _factor_residual_gate(A):
    """safe_cholesky on the card (K2-K4 at n=1024) against the plain version
    of its steps (``fullchol.fused_cholesky_reference``) on the identical
    float32 matrix A + jm I, jm 10x the larger of the jitters that the route
    and cholesky_ex needed on A: the backward error ||L L^T - A'||_F /
    ||A'||_F within 3x the plain version's (a wrong factor is off by O(1)).
    Returns the two factors' errors against float64's factor of A'."""
    jm = 10.0 * float(linalg.safe_cholesky(A)[1])
    info = torch.linalg.cholesky_ex(A)[1]
    j = torch.finfo(A.dtype).eps * max(float(A.diagonal().abs().mean()), 1.0)
    while int(info):
        info = torch.linalg.cholesky_ex(linalg.add_diagonal(A, j))[1]
        jm, j = max(jm, 10.0 * j), 10.0 * j
    Aj = linalg.add_diagonal(A, jm)
    _cuda.reset_launch_counts()
    L, jit = linalg.safe_cholesky(Aj)
    assert float(jit) == 0.0
    assert all(_cuda.launch_counts()[f] > 0 for f in ("panel_update", "diag_factor_inv", "panel_solve"))
    Lp = fullchol.fused_cholesky_reference(Aj)[0]
    assert bool(torch.isfinite(Lp[-1, -1]))
    A64 = Aj.double()

    def resid(F):
        F = F.double()
        return float(torch.linalg.matrix_norm(F @ F.T - A64) / torch.linalg.matrix_norm(A64))

    assert resid(L) <= 3 * resid(Lp)
    L64 = torch.linalg.cholesky(A64)
    return _relerr(L.double(), L64), _relerr(Lp.double(), L64)


# lengthscale 0.8 keeps the Woodbury inner matrix at cond <= 4e3 at n=4096,
# m=1024: float32 resolves it, so the 3x gates compare K2-K4's route with
# the plain one on rounding (at bench_sparse's lengthscale 2 its cond
# is 6.6e9 and every float32 route misses float64's mean by tens of percent);
# the bench lengthscale keeps the route, launch and backward-error checks
@pytest.mark.parametrize("m,route,ls", [(1024, "fused-matrix", 0.8), (512, "torch-cholesky", 0.8),
                                        (1024, "fused-matrix", 2.0)])
def test_sparse_fit_route_and_launches_on_the_card(dev, m, route, ls):
    from gpr_tpu_torch.gp import sparse

    X, Y, Z = _sparse_data(4096, m)
    Xs = np.random.default_rng(1).standard_normal((64, 8))
    k = tg.Gaussian(ls, 1.0)
    _cuda.reset_launch_counts()
    sg = sparse.fit_sparse(k, _t(Z, dev), _t(X, dev), _t(Y, dev), 0.3, 1e-4)
    torch.cuda.synchronize()
    c = _cuda.launch_counts()
    assert sg.route == route
    fused = ("panel_update", "diag_factor_inv", "panel_solve")
    if route == "fused-matrix":  # both m x m factorizations on K2-K4
        assert all(c[name] > 0 for name in fused) and c["syrk_update"] == 0
        Zt, Xt = _t(Z, dev), _t(X, dev)
        Kmm = linalg.add_diagonal(tg.gram(k, Zt), 1e-4)
        Knm = tg.gram(k, Xt, Zt)
        for A in (Kmm, Kmm + Knm.T @ Knm / 0.09):
            err, plain = _factor_residual_gate(A)
            if ls < 1.0:  # float32 resolves the factor itself
                assert err <= 3 * plain
    else:
        assert sum(c.values()) == 0
    if ls > 1.0:
        return
    ref = sparse.fit_sparse(k, Z, X, Y, 0.3, 1e-4, device="cpu")
    cpu32 = sparse.fit_sparse(k, *(a.astype(np.float32) for a in (Z, X, Y)), 0.3, 1e-4, device="cpu")
    Xs_t = _t(Xs, dev)
    m64, m32 = ref.predict(Xs), cpu32.predict(Xs.astype(np.float32)).double()
    assert _relerr(sg.predict(Xs_t).cpu().double(), m64) <= 3 * _relerr(m32, m64) + 1e-6
    c64 = torch.stack([ref.credible_interval(x) for x in Xs[:8]])
    c32 = torch.stack([cpu32.credible_interval(x) for x in Xs[:8].astype(np.float32)]).double()
    got = torch.stack([sg.credible_interval(x) for x in Xs_t[:8]]).cpu().double()
    assert _relerr(got, c64) <= 3 * _relerr(c32, c64) + 1e-6


def test_sparse_log_posterior_route_and_launches_on_the_card(dev):
    from gpr_tpu_torch.inference import hmc

    X, Y, Z = _sparse_data(2048, 512, q=1)
    # lengthscales 0.61-1.0 keep the Woodbury inner matrix at cond <= 3e4:
    # float32 resolves it, so the fleet route and the plain one are compared
    # on rounding (at lengthscale 1.65 its cond is 1.5e7, and two float32
    # factorizations of it differ by more than 3x at random)
    z = np.random.default_rng(2).uniform([-0.5, -0.5], [0.0, 0.5], (4, 2))
    k = tg.Gaussian(1.0, 1.0)

    def value_grad(dtype, use_crout):
        t = [torch.tensor(a, dtype=dtype, device=dev) for a in (Z, X, Y, z)]
        f = hmc.make_sparse_gp_log_posterior(k, *t[:3], 0.3, jitter=1e-4, use_crout=use_crout)
        return f.route, hmc._value_and_grad(f)(t[3])

    # float64 and the plain float32 route (torch's batched Cholesky) on the card
    (_, (v64, g64)), (_, (v32, g32)) = value_grad(torch.float64, None), value_grad(torch.float32, False)
    _cuda.reset_launch_counts()
    route, (v, g) = value_grad(torch.float32, None)
    assert route == "fleet-crout"
    # Kmm and the inner matrix of the 4 chains: one fleet of 8, one
    # factorization in the forward, none in the backward
    assert _cuda.launch_counts()["crout_chol"] == 512 // fleet_ops.PANEL
    assert _relerr(v.double(), v64) <= 3 * _relerr(v32.double(), v64) + 1e-7
    assert _relerr(g.double(), g64) <= 3 * _relerr(g32.double(), g64) + 1e-6


# ---------------------------------------------------------------------------
# the serving loop's CUDA graph and the image pipeline on the card
# ---------------------------------------------------------------------------

SERVE_CONFIG = {"n_inputModes": 5, "n_outputModes": 3}


def _serve_model(tmp_path, dev, n=600, hw=16, dvf=3 * 4 ** 3, seed=60):
    """A model the serve app loads: PCA bases of random frames and DVFs and an
    exact GP on their features, saved in float32 by the port."""
    from gpr_tpu_torch.pipeline import pca

    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 255, (hw * hw, n)) / 255.0
    fields = rng.standard_normal((dvf, n))
    in_pca, out_pca = pca.fit_pca(_t(frames, dev)), pca.fit_pca(_t(fields, dev))
    X = in_pca.reduce(_t(frames, dev), SERVE_CONFIG["n_inputModes"]).T.contiguous()
    Y = out_pca.reduce(_t(fields, dev), SERVE_CONFIG["n_outputModes"]).T.contiguous()
    prefix = str(tmp_path / "gpr")
    tg.fit(tg.Gaussian(2.0, 1.0), X, Y, sigma=0.1).save(prefix)
    in_pca.save(prefix + "-input")
    out_pca.save(prefix + "-output")
    return prefix, [rng.uniform(0, 255, (hw, hw)) for _ in range(4)]


def test_serve_graph_matches_its_eager_program(dev, tmp_path):
    from gpr_tpu_torch.apps import serve

    prefix, frames = _serve_model(tmp_path, dev)
    server = serve.Server(SERVE_CONFIG, prefix, str(tmp_path / "out"))
    assert server.device.type == "cuda" and server.gp.X.dtype == torch.float32
    server.warmup(frames[0])
    for i, f in enumerate(frames):
        got, want = server.run(f), server.run_eager(f)
        assert got.dtype == np.float32 and got.shape == want.shape == (3 + 1 + 3 * 4 ** 3,)
        # the graph replays the eager program's kernels on the same inputs
        np.testing.assert_array_equal(got, want)
        server.handle_frame(f, i)
    assert len(server._graphs) == 1
    assert server.replays == 2 * len(frames)
    # a frame is one graph launch, one copy in, one host read and one synchronisation
    from torch.profiler import ProfilerActivity, profile, schedule

    # the warm-up frame starts the profiler's device tracing before the counted one
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for f in frames[:2]:
            server.run(f)
            prof.step()
    names = [e.name for e in prof.events()]
    seen = {k: sum(nm.startswith(k) for nm in names) for k in (
        "cudaGraphLaunch", "cudaLaunchKernel", "cudaStreamSynchronize", "Memcpy HtoD", "Memcpy DtoH")}
    assert seen == {"cudaGraphLaunch": 1, "cudaLaunchKernel": 0, "cudaStreamSynchronize": 1,
                    "Memcpy HtoD": 1, "Memcpy DtoH": 1}, seen
    assert sorted(os.listdir(tmp_path / "out")) == [f"dvf{i:05d}.npy" for i in range(len(frames))]
    # a frame of another size is another program: the basis refuses it while its graph is made
    with pytest.raises(RuntimeError):
        server.run(np.zeros((8, 8)))


def test_serve_capture_failure_raises(dev, tmp_path):
    from gpr_tpu_torch.apps import serve

    prefix, frames = _serve_model(tmp_path, dev, n=200)
    server = serve.Server(SERVE_CONFIG, prefix, str(tmp_path / "out"))
    # a host read inside the per-frame program cannot be captured
    server._pipeline = lambda col: col * col.sum().item()
    with pytest.raises(RuntimeError, match="capturing the per-frame program"):
        server.warmup(frames[0])
    assert server.replays == 0 and not server._graphs


def test_warp_order_3_against_scipy_on_the_card(dev):
    import scipy.ndimage as ndi

    from gpr_tpu_torch.pipeline import warp

    rng = np.random.default_rng(61)
    img = rng.standard_normal((12, 10, 9))
    disp = rng.uniform(-3.0, 3.0, img.shape + (3,))
    grid = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in img.shape], indexing="ij")
    want = ndi.map_coordinates(img, [grid[ax] + disp[..., 2 - ax] for ax in range(3)], order=3, mode="mirror")
    got64 = warp.warp_array(torch.tensor(img, device=dev), torch.tensor(disp, device=dev), order=3)
    assert got64.device.type == "cuda"
    np.testing.assert_allclose(got64.cpu().numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())
    got32 = warp.warp_array(_t(img, dev), _t(disp, dev), order=3)
    # float32 taps of a float64 prefilter: a few ulp of the image's range
    np.testing.assert_allclose(got32.cpu().double().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_histogram_matching_and_median_filter_on_the_card(dev):
    from gpr_tpu_torch.pipeline import filters

    rng = np.random.default_rng(62)
    a, b = rng.uniform(0, 255, (16, 20, 12)), rng.uniform(-10, 90, (16, 20, 12))
    for dtype in (torch.float64, torch.float32):
        ta, tb = (torch.tensor(x, dtype=dtype) for x in (a, b))
        med = filters.median_filter(ta.to(dev), 1)
        assert med.device.type == "cuda"
        # a selection: the same value either way
        torch.testing.assert_close(med.cpu(), filters.median_filter(ta, 1), rtol=0, atol=0)
        got, want = filters.histogram_matching(ta.to(dev), tb.to(dev)).cpu(), filters.histogram_matching(ta, tb)
        tol = 1e-12 if dtype == torch.float64 else 2e-6
        torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))


# ---------------------------------------------------------------------------
# utils/profiling.py on the card: spans and host waits
# ---------------------------------------------------------------------------

def _gauss_data(dev, n, d, q, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.randn(n, d, generator=g, device=dev), torch.randn(n, q, generator=g, device=dev))


def test_fit_spans_stay_off_the_device_timeline_and_add_up(dev):
    """A profiled fit shows no device event named ``gpr.*`` (the spans are
    host ``cpu_op`` events, not annotations that the profiler mirrors onto
    the device), and the device time of ``gpr.fit.factor`` and
    ``gpr.fit.solve`` adds up to within 5 % of ``gpr.fit``'s."""
    from torch.profiler import ProfilerActivity, profile

    from gpr_tpu_torch.utils import profiling as prof

    X, Y = _gauss_data(dev, 4096, 32, 4, 71)
    k = tg.Gaussian(4.0, 1.0)
    tg.fit(k, X, Y, sigma=0.1)
    torch.cuda.synchronize()
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(3):
            gp = tg.fit(k, X, Y, sigma=0.1)
        torch.cuda.synchronize()
    assert gp.route == "fused-gram"
    events = [e for e in p.profiler.kineto_results.events() if e.name().startswith("gpr.")]
    assert len(events) == 9 and all(str(e.device_type()).endswith("CPU") for e in events)
    recs = prof.spans()
    for call in {r["call"] for r in recs}:
        ms = {r["name"]: r["device_ms"] for r in recs if r["call"] == call}
        assert ms["gpr.fit.factor"] > 0 and ms["gpr.fit.solve"] > 0
        assert abs(ms["gpr.fit.factor"] + ms["gpr.fit.solve"] - ms["gpr.fit"]) <= 0.05 * ms["gpr.fit"], ms


@pytest.mark.parametrize("what,n", [("fit_mle", 1100), ("fit_mle", 1024), ("fit", 1024), ("fit", 700)])
def test_host_wait_counters_match_sync_debug_mode(dev, what, n):
    """Over one request the port's ``host_wait.*`` counters rise by as many as
    the points where ``torch.cuda.set_sync_debug_mode("warn")`` flags the
    host waiting for the card: training on ``blocked-syrk`` (n=1100) and
    ``fused-matrix`` (n=1024), fits on ``fused-gram`` and (n=700,
    ``use_pallas_gram=False``) the matrix route."""
    import warnings

    from gpr_tpu_torch.utils import profiling as prof

    X, Y = _gauss_data(dev, n, 5, 3, 72)
    k = tg.Gaussian(2.0, 1.0)
    if what == "fit_mle":
        def run():
            tg.fit_mle(k, X, Y, 0.1, iterations=3)
    else:
        def run():
            tg.fit(k, X, Y, sigma=0.1, use_pallas_gram=None if n % 128 == 0 else False)
    run()
    torch.cuda.synchronize()
    before = prof.counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    flagged = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    waits = {kk: v - before.get(kk, 0) for kk, v in prof.counters().items()
             if kk.startswith("host_wait.") and v != before.get(kk, 0)}
    assert flagged > 0 and sum(waits.values()) == flagged, (flagged, waits)
