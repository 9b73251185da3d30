"""The port's fleet (gpr_tpu_torch.gp.batched, ops.batched) against gpr_tpu's
(gp/batched.py, ops/pallas_batched.py with its Pallas kernels in interpret
mode), on the CPU.

Both packages get the same numpy inputs.  Tolerances: float64 results
agree to 1e-10 relative (the same factorization, summed in other orders;
the fleet route and torch's differ only in rounding, since the factor is
unique).  float32 results agree to 1e-5 relative for well-conditioned
fleets (sigma 0.5: cond(K + sigma^2 I) ~ 1e2, so two float32 solves differ
by ~cond * eps ~ 1e-5).  Traces of 20 Adam steps agree to 1e-8 relative,
as for ``fit_mle`` (tests/test_torch_optimize.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from gpr_tpu.gp import batched as jb
from gpr_tpu.gp import likelihood as jlk
from gpr_tpu.ops import pallas_batched as jpb
from gpr_tpu_torch import convert
from gpr_tpu_torch.gp import batched as tb
from gpr_tpu_torch.ops import _cuda
from gpr_tpu_torch.ops import batched as tob


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _fleet(B=3, n=64, d=2, q=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, d))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.05 * rng.standard_normal((B, n, q))
    return X, Y


def _spd(B, n, seed):
    G = np.random.default_rng(seed).standard_normal((B, n, n))
    return (G @ G.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def test_cholesky_and_solve_match_jax():
    A = _spd(3, 128, 3)
    Lj, Wj = jpb.cholesky_batched(jnp.asarray(A), panel=32, interpret=True, return_winv=True)
    junk = A.copy()
    junk[:, np.triu_indices(128, 1)[0], np.triu_indices(128, 1)[1]] = np.nan
    _cuda.reset_launch_counts()
    Lt, Wt = tob.cholesky_batched(torch.tensor(junk), panel=32, return_winv=True)  # lower read
    assert _cuda.launch_counts()["crout_chol"] == 0
    assert Wt.shape == (3, 4, 32, 32) and not torch.triu(Lt, 1).any()
    assert _rel(Lt, Lj) < 1e-5 and _rel(Wt, Wj) < 1e-5
    ref = np.linalg.cholesky(A.astype(np.float64))
    assert _rel(Lt, ref) < 1e-5
    Bm = np.random.default_rng(4).standard_normal((3, 128, 2)).astype(np.float32)
    Xj = np.asarray(jpb.cho_solve_batched(Lj, jnp.asarray(Bm), panel=32, winv=Wj))
    truth = np.linalg.solve(A.astype(np.float64), Bm.astype(np.float64))
    for winv in (Wt, None):  # the inverses of the sweep, or re-derived from L
        Xt = tob.cho_solve_batched(Lt, torch.tensor(Bm), panel=32, winv=winv)
        assert _rel(Xt, Xj) < 1e-5 and _rel(Xt, truth) < 1e-5


def test_failed_member_stays_in_its_place():
    A = _spd(3, 64, 5)
    A[1, 40, 40] = -1e4
    L = tob.cholesky_batched(torch.tensor(A), panel=32)
    assert not torch.isfinite(L[1, -1, -1])
    ref = np.linalg.cholesky(A[[0, 2]].astype(np.float64))
    assert _rel(L[[0, 2]], ref) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("use_crout", [True, None])
def test_fit_batched_matches_jax(dtype, tol, use_crout):
    X, Y = _fleet()
    X, Y = X.astype(dtype), Y.astype(dtype)
    fj = jb.fit_batched(jg.Gaussian(1.2, 0.9), jnp.asarray(X), jnp.asarray(Y), sigma=0.5,
                        use_crout=use_crout)
    ft = tb.fit_batched(tg.Gaussian(1.2, 0.9), X, Y, 0.5, use_crout=use_crout, device="cpu")
    assert ft.route == ("fleet-crout" if use_crout else "torch-cholesky")
    assert ft.L.dtype == torch.from_numpy(X).dtype and ft.alpha.shape == (3, 64, 2)
    assert _rel(ft.L, fj.L) < tol and _rel(ft.alpha, fj.alpha) < tol
    assert not torch.triu(ft.L, 1).any()


def test_predict_and_variance_with_per_member_sigma():
    X, Y = _fleet(B=3, n=32, seed=1)
    sig = np.array([0.01, 0.1, 1.0])
    k = (jg.Gaussian(1.0, 1.0), tg.Gaussian(1.0, 1.0))
    fj = jb.fit_batched(k[0], jnp.asarray(X), jnp.asarray(Y), sigma=jnp.asarray(sig))
    for use_crout in (False, True):
        ft = tb.fit_batched(k[1], X, Y, torch.tensor(sig), use_crout=use_crout, device="cpu")
        Xs = X[:, :5]
        assert _rel(tb.predict_batched(ft, Xs), jb.predict_batched(fj, jnp.asarray(Xs))) < 1e-10
        assert _rel(tb.variance_batched(ft, Xs), jb.variance_batched(fj, jnp.asarray(Xs))) < 1e-10
        gp1 = tg.fit(k[1], X[1], Y[1], 0.1, device="cpu")  # one member alone
        assert _rel(ft.alpha[1], gp1.alpha) < 1e-10


def test_batched_hyperparameter_grid():
    """A lengthscale grid scored in one call: every kernel leaf carries the
    fleet axis (test_batched.py:166-184)."""
    rng = np.random.default_rng(1)
    x = np.linspace(0, 6, 40)
    y = np.sin(x) + 0.1 * rng.standard_normal(40)
    Bg = 8
    sigmas = np.geomspace(0.2, 5.0, Bg)
    X = np.broadcast_to(x[None, :, None], (Bg, 40, 1)).copy()
    Y = np.broadcast_to(y[None, :, None], (Bg, 40, 1)).copy()
    mj = jb.mll_batched(jg.Gaussian(jnp.asarray(sigmas), jnp.ones(Bg)), jnp.asarray(X),
                        jnp.asarray(Y), sigma=0.1, batched_kernel=True)
    kt = tg.Gaussian(torch.tensor(sigmas), torch.ones(Bg))
    mt = tb.mll_batched(kt, X, Y, 0.1, batched_kernel=True, device="cpu")
    assert mt.shape == (Bg,) and _rel(mt, mj) < 1e-10
    ref = float(jlk.mll_scalar(jg.Gaussian(float(sigmas[3]), 1.0), x, y, 0.1))
    assert abs(float(mt[3]) - ref) <= 1e-10 * abs(ref)
    # the float32 fit of the grid goes through K6's plain version with one
    # parameter row per member
    fj = jb.fit_batched(jg.Gaussian(jnp.asarray(sigmas, jnp.float32), jnp.ones(Bg, jnp.float32)),
                        jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), sigma=0.5,
                        batched_kernel=True)
    ft = tb.fit_batched(kt, X.astype(np.float32), Y.astype(np.float32), 0.5,
                        batched_kernel=True, device="cpu")
    assert _rel(ft.alpha, fj.alpha) < 1e-5


def test_kernel_validation_checks_every_member():
    with pytest.raises(ValueError):
        tg.Gaussian(torch.tensor([1.0, -1.0]), torch.ones(2))
    with pytest.raises(ValueError):
        tg.Gaussian(torch.ones(2), torch.tensor([1.0, float("nan")]))
    ard = tg.GaussianARD(torch.ones((3, 2)) * torch.tensor([1.0, 2.0]), torch.ones(3))
    assert len(ard.params) == 3 and ard.params[1].shape == (3,)
    X = torch.randn(3, 5, 2, dtype=torch.float64)
    K = tb.fit_batched(ard, X, X[..., :1], 0.1, batched_kernel=True, device="cpu").L
    K1 = tg.fit(tg.GaussianARD(torch.tensor([1.0, 2.0]), 1.0), X[1], X[1, :, :1], 0.1,
                device="cpu").L
    assert _rel(K[1], K1) < 1e-12


@pytest.mark.parametrize("use_crout", [True, False])
def test_mll_value_and_gradient_match_jax(use_crout):
    X, Y = _fleet(B=2, n=64, d=3, seed=3)

    def jloss(p):
        return jnp.sum(jb.mll_batched(jg.Gaussian(p[0], p[1]), jnp.asarray(X), jnp.asarray(Y),
                                      0.2, batched_kernel=True, use_crout=False))

    p0 = np.array([[1.7, 1.1], [0.9, 1.3]])  # (P, B): each member its own
    vj, gj = jax.value_and_grad(jloss)(jnp.asarray(p0))
    p = torch.tensor(p0, requires_grad=True)
    mt = tb.mll_batched(tg.Gaussian(p[0], p[1]), X, Y, 0.2, batched_kernel=True,
                        use_crout=use_crout, device="cpu")
    (gt,) = torch.autograd.grad(mt.sum(), p)
    assert abs(float(mt.detach().sum()) - float(vj)) <= 1e-10 * abs(float(vj))
    assert _rel(gt, gj) < 1e-9


def test_fit_mle_batched_traces_match_jax():
    X, Y = _fleet(B=2, n=32, d=1, seed=5)
    init = np.array([[0.6, 1.0], [2.5, 0.8]])
    kw = dict(iterations=20, learning_rate=0.05)
    kj, rj = jb.fit_mle_batched(jg.Gaussian(1.0, 1.0), jnp.asarray(X), jnp.asarray(Y), 0.1,
                                use_crout=False, init=jnp.asarray(init), **kw)
    for use_crout in (True, None):
        kt, rt = tb.fit_mle_batched(tg.Gaussian(1.0, 1.0), X, Y, 0.1, use_crout=use_crout,
                                    init=init, device="cpu", **kw)
        assert rt.route == ("fleet-crout" if use_crout else "torch-cholesky")
        assert rt.trace.shape == (20,) and rt.params.shape == (2, 2)
        assert _rel(rt.trace, rj.trace) < 1e-8 and _rel(rt.params, rj.params) < 1e-8
        assert abs(rt.value - rj.value) <= 1e-8 * abs(rj.value)
        assert kt.sigma.shape == (2,)


def test_fleet_from_numpy_round_trip():
    X, Y = _fleet(B=3, n=20, seed=6)
    sig = np.array([0.1, 0.2, 0.3])
    kj = jg.Gaussian(jnp.asarray([1.0, 1.5, 2.0]), jnp.asarray([1.0, 0.5, 2.0]))
    fj = jb.fit_batched(kj, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(sig), batched_kernel=True)
    state = {"kernel": ("Gaussian", [np.asarray(kj.sigma), np.asarray(kj.scale)]),
             **{k: np.asarray(getattr(fj, k)) for k in ("X", "Y", "sigma", "alpha", "L")},
             "batched_kernel": fj.batched_kernel}
    ft = convert.fleet_from_numpy(state, device="cpu")
    assert ft.route == "converted" and ft.batched_kernel
    Xs = X[:, :4]
    assert _rel(tb.predict_batched(ft, Xs), jb.predict_batched(fj, jnp.asarray(Xs))) < 1e-12
    assert _rel(tb.variance_batched(ft, Xs), jb.variance_batched(fj, jnp.asarray(Xs))) < 1e-10
    refit = tb.fit_batched(ft.kernel, X, Y, sig, batched_kernel=True, device="cpu")
    assert _rel(refit.alpha, fj.alpha) < 1e-10


def test_numpy_input_without_a_device_raises(monkeypatch):
    # the entry points run on the card unless told otherwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = _fleet(B=2, n=8)
    k = tg.Gaussian(1.0)
    for call in (lambda: tg.fit_batched(k, X, Y, 0.1),
                 lambda: tg.mll_batched(k, X, Y, 0.1),
                 lambda: tb.fit_mle_batched(k, X, Y, 0.1, iterations=1),
                 lambda: convert.fleet_from_numpy({"kernel": "GaussianKernel(1,1,)", "X": X,
                                                   "Y": Y, "sigma": [0.1, 0.1], "alpha": Y,
                                                   "L": X})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    gp = tg.fit_batched(k, torch.tensor(X), torch.tensor(Y), 0.1)  # CPU tensors run here
    assert gp.route == "torch-cholesky" and gp.X.device.type == "cpu"
    assert tg.predict_batched(gp, X[:, :2]).shape == (2, 2, 2)
    assert math.isfinite(float(tg.mll_batched(k, X, Y, 0.1, device="cpu").sum()))


def test_fleet_route_never_names_a_kernel_that_refuses_the_shape(monkeypatch):
    # K9 takes n <= FUSED_MAX_N; a raised GPR_FLEET_FUSED_MAX_N must not send
    # a larger fleet to it (factor_solve_fused raises there)
    monkeypatch.setattr(tob, "_FLEET_FUSED_MAX_N", 4096)
    f32 = torch.float32
    assert tb.fleet_route(2176, f32, "cuda", use_crout=True) == "fleet-crout"
    assert tb.fleet_route(2176, f32, "cuda") == "fleet-crout"
    assert tb.fleet_route(tob.FUSED_MAX_N, f32, "cuda") == "fleet-fused"
    monkeypatch.setattr(tob, "_FLEET_FUSED_MAX_N", 0)
    assert tb.fleet_route(512, f32, "cuda") == "fleet-crout"


def test_fleet_gram_switch(monkeypatch):
    # GPR_FLEET_GRAM (batched.py:138-146), read at call time: pallas (default)
    # builds K with K6, anything else with the vmapped torch Gram
    from gpr_tpu_torch.ops import gram as tgram

    X, Y = _fleet(B=3, n=64)
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    calls = []
    orig = tgram.gram_batched
    monkeypatch.setattr(tgram, "gram_batched", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    k = tg.Gaussian(1.5, 1.0)
    a = tb.fit_batched(k, X32, Y32, 0.3, device="cpu")
    assert calls == [1]
    monkeypatch.setenv("GPR_FLEET_GRAM", "xla")
    b = tb.fit_batched(k, X32, Y32, 0.3, device="cpu")
    assert calls == [1] and a.route == b.route
    assert _rel(b.alpha.numpy(), a.alpha.numpy()) < 1e-4
    jbgp = jb.fit_batched(jg.Gaussian(1.5, 1.0), X32, Y32, 0.3)  # JAX on the CPU: its XLA Gram
    assert _rel(b.alpha.numpy(), np.asarray(jbgp.alpha)) < 1e-4
