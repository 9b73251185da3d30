"""Exact GP fit -> predict of the port (gpr_tpu_torch.gp.exact) against
gpr_tpu.gp.exact, on the model of __graft_entry__.entry(): Sum(Gaussian(1.5, 1),
White(0.1)), sigma 0.1, n=256, d=8, q=4, 64 test points, __graft_entry__'s
dataset seeds.

Bounds: 1e-10 of the largest magnitude at float64 (same algorithm, other
summation order) and 1e-5 at float32 (the factor and solves amplify float32
rounding by the conditioning of K + sigma^2 I).
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from __graft_entry__ import _make_dataset
from gpr_tpu.gp import exact as jexact
from gpr_tpu_torch import convert
from gpr_tpu_torch.gp import exact
from gpr_tpu_torch.ops import solve as tsolve

ENTRY_KERNEL = "SumKernel(GaussianKernel(1.5,1,),WhiteKernel(0.10000000000000001,))"
BOUND = {np.float64: 1e-10, np.float32: 1e-5}


def _entry_data(dtype):
    X, Y = _make_dataset(256, 8, 4, dtype)
    Xs = np.random.default_rng(1).standard_normal((64, 8)).astype(dtype)
    return np.asarray(X), np.asarray(Y), Xs


def _err(a, b, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / (np.abs(b).max() if scale is None else scale)


def _close(a, b, bound, scale=None):
    err = _err(a, b, scale)
    assert err <= bound, f"relative error {err} > {bound}"


def _jax_kernel(dtype):
    import jax.numpy as jnp

    return jg.Sum(jg.Gaussian(jnp.asarray(1.5, dtype), jnp.asarray(1.0, dtype)),
                  jg.White(jnp.asarray(0.1, dtype)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_entry_model_parity(dtype):
    X, Y, Xs = _entry_data(dtype)
    gj = jexact.fit(_jax_kernel(dtype), X, Y, sigma=0.1)
    gt = tg.fit(tg.parse_kernel(ENTRY_KERNEL), torch.tensor(X), torch.tensor(Y), sigma=0.1)
    assert gt.route == "torch-cholesky"
    assert gt.alpha.dtype == torch.tensor(X).dtype
    bound = BOUND[dtype]
    _close(gt.alpha.numpy(), gj.alpha, bound)
    Xt = torch.tensor(Xs)
    _close(gt.predict(Xt).numpy(), gj.predict(Xs), bound)
    _close(gt.credible_interval(Xt).numpy(), gj.credible_interval(Xs), bound)
    _close(gt.predict(Xt[3]).numpy(), gj.predict(Xs[3]), bound)
    _close(gt.credible_interval(Xt[3]).numpy(), gj.credible_interval(Xs[3]), bound)
    # a posterior covariance is measured against the prior variance k(x, x)
    # (~1.01): between two distant points it is itself close to 0
    _close(gt.posterior_cov(Xt[0], Xt[1]).numpy(), gj.posterior_cov(Xs[0], Xs[1]), bound,
           scale=float(gj.kernel(Xs[0], Xs[0])))
    _close(gt.posterior_var(Xt).numpy(), gj.posterior_var(Xs), bound)


def test_sinus_gate():
    # reference Test1 (GaussianProcessTest.cpp:35-76): sum |err| < 0.0008
    xs = np.arange(10) * 2 * math.pi / 10
    gp = tg.fit(tg.Gaussian(2.889), torch.tensor(xs[:, None]), torch.tensor(np.sin(xs)[:, None]),
                sigma=0.0)
    xt = np.arange(50) * 2 * math.pi / 50
    pred = gp.predict(torch.tensor(xt[:, None])).numpy()[:, 0]
    assert np.sum(np.abs(pred - np.sin(xt))) < 0.0008


def _files(prefix):
    return [prefix + s for s in ("-RegressionVectors.txt", "-CoreMatrix.txt",
                                 "-SampleVectors.txt", "-LabelVectors.txt",
                                 "-ParameterFile.txt")]


def test_save_port_load_jax(tmp_path):
    X, Y, Xs = _entry_data(np.float64)
    gt = tg.fit(tg.parse_kernel(ENTRY_KERNEL), torch.tensor(X), torch.tensor(Y), sigma=0.1)
    prefix = str(tmp_path / "port")
    gt.save(prefix)
    assert all(os.path.exists(f) for f in _files(prefix))
    gj = jg.load(prefix)
    _close(np.asarray(gj.predict(Xs)), gt.predict(torch.tensor(Xs)).numpy(), 1e-10)
    _close(np.asarray(gj.credible_interval(Xs)),
           gt.credible_interval(torch.tensor(Xs)).numpy(), 1e-10)


def test_save_jax_load_port(tmp_path):
    X, Y, Xs = _entry_data(np.float64)
    gj = jexact.fit(_jax_kernel(np.float64), X, Y, sigma=0.1)
    prefix = str(tmp_path / "jax")
    gj.save(prefix)
    gt = tg.load(prefix, device="cpu")
    assert gt.L is None and gt.core is not None and gt.route == "loaded"
    assert gt.kernel.to_string() == gj.kernel.to_string()
    _close(gt.predict(torch.tensor(Xs)).numpy(), np.asarray(gj.predict(Xs)), 1e-10)
    _close(gt.credible_interval(torch.tensor(Xs)).numpy(),
           np.asarray(gj.credible_interval(Xs)), 1e-10)
    # a loaded model saved again keeps its CoreMatrix and flags it as kept
    again = str(tmp_path / "again")
    gt.save(again)
    with open(again + "-ParameterFile.txt") as f:
        assert f.read().split()[3] == "0"
    _close(tg.load(again, device="cpu").core.numpy(), gt.core.numpy(), 0.0)


def test_efficient_storage(tmp_path):
    X, Y, Xs = _entry_data(np.float64)
    full = tg.fit(tg.parse_kernel(ENTRY_KERNEL), torch.tensor(X), torch.tensor(Y), sigma=0.1)
    eff = tg.fit(tg.parse_kernel(ENTRY_KERNEL), torch.tensor(X), torch.tensor(Y), sigma=0.1,
                 efficient_storage=True)
    assert eff.L is None
    _close(eff.credible_interval(torch.tensor(Xs)).numpy(),
           full.credible_interval(torch.tensor(Xs)).numpy(), 1e-10)
    _close(eff.materialize().L.numpy(), full.L.numpy(), 1e-12)
    prefix = str(tmp_path / "eff")
    eff.save(prefix)
    with open(prefix + "-ParameterFile.txt") as f:
        assert f.read().split()[3] == "1"


def test_gp_from_numpy_reproduces_predictions():
    X, Y, Xs = _entry_data(np.float64)
    gj = jexact.fit(_jax_kernel(np.float64), X, Y, sigma=0.1)
    state = {"kernel": gj.kernel.to_string(), "X": gj.X, "Y": gj.Y, "sigma": gj.sigma,
             "alpha": gj.alpha, "L": gj.L, "core": None}
    gt = convert.gp_from_numpy(state, device="cpu")
    _close(gt.predict(torch.tensor(Xs)).numpy(), np.asarray(gj.predict(Xs)), 1e-12)
    _close(gt.credible_interval(torch.tensor(Xs)).numpy(),
           np.asarray(gj.credible_interval(Xs)), 1e-12)


def test_kernel_from_numpy_tree():
    import dataclasses

    jk = jg.Sum(jg.Product(jg.Gaussian(2.0, 1.5), jg.Periodic(1.5, 0.8, 1.1)),
                jg.GaussianARD(np.array([0.5, 1.5]), 1.2))

    def tree(k):
        if isinstance(k, (jg.Sum, jg.Product)):
            return type(k).__name__, [tree(k.k1), tree(k.k2)]
        return type(k).__name__, [np.asarray(getattr(k, f.name))
                                  for f in dataclasses.fields(k)]

    tk = convert.kernel_from_numpy(tree(jk))
    assert tk.to_string() == jk.to_string()
    assert convert.kernel_from_numpy(jk.to_string()).to_string() == jk.to_string()


def test_routes_on_cpu(rng):
    X = torch.tensor(rng.standard_normal((1024, 3)), dtype=torch.float32)
    Y = torch.tensor(rng.standard_normal((1024, 1)), dtype=torch.float32)
    k = tg.Gaussian(1.5, 1.0)
    # no fused or SYRK-kernel route without a CUDA tensor
    assert tg.fit(k, X, Y, 0.1).route == "blocked"
    assert tg.fit(k, X, Y, 0.1, use_pallas_gram=True).route == "gram-kernel"
    assert tg.fit(tg.parse_kernel(ENTRY_KERNEL), X, Y, 0.1, use_pallas_gram=True).route == \
        "blocked"  # Sum is not a Gram-kernel form


@pytest.mark.parametrize("kstr", ["GaussianKernel(1.5,1.2,)", "PeriodicKernel(1.1,0.7,1.3,)"])
def test_gram_kernel_fit_matches_jax(kstr, rng):
    # use_pallas_gram on the CPU: K1's plain version in the port, the
    # interpret-mode Pallas kernel in JAX.  Both are float32 fits whose error
    # (~1e-4 here) is set by the conditioning of K + sigma^2 I, so each is
    # held against a float64 fit and the port's error must stay within 3x
    # the JAX package's (the ratio gate of ADVICE.md:5)
    X = rng.standard_normal((300, 3)).astype(np.float32)
    Y = rng.standard_normal((300, 2)).astype(np.float32)
    Xs = rng.standard_normal((20, 3)).astype(np.float32)
    gj = jexact.fit(jg.parse_kernel(kstr), X, Y, sigma=0.3, use_pallas_gram=True)
    gt = tg.fit(tg.parse_kernel(kstr), torch.tensor(X), torch.tensor(Y), sigma=0.3,
                use_pallas_gram=True)
    assert gt.route == "gram-kernel"
    g64 = tg.fit(tg.parse_kernel(kstr), torch.tensor(X, dtype=torch.float64),
                 torch.tensor(Y, dtype=torch.float64), sigma=float(np.float32(0.3)))
    truth = g64.predict(torch.tensor(Xs, dtype=torch.float64)).numpy()
    err_port = _err(gt.predict(torch.tensor(Xs)).numpy(), truth)
    err_jax = _err(np.asarray(gj.predict(Xs)), truth)
    assert err_port <= 3 * err_jax, (err_port, err_jax)


# --- the rest of gp/exact.py: the sliding window and the diagnostics --------
#
# float64: 1e-10 of the largest magnitude against the JAX package (same
# formulas, other summation order).  float32 under GPR_SOLVE_SCHEDULE=narrow:
# each package's error against float64 is set by the conditioning of
# K + sigma^2 I, so the port's must stay within 3x JAX's.  JAX's shrink is a
# fori_loop of n column steps per dropped sample (~1.4 s each on the CPU at
# n ~ 1500), so it drops 2 samples here; the port's k = 512 is held to a
# fresh fit on the same window.

def _window_data(n, k, dtype, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n + k, 5))
    Y = np.sin(X[:, :3]) + 0.1 * rng.standard_normal((n + k, 3))
    return X.astype(dtype), Y.astype(dtype)


def test_window_matches_jax_float64():
    n, k = 1024, 512
    X, Y = _window_data(n, k, np.float64)
    gj = jexact.fit(jg.Gaussian(2.0, 1.0), X[:n], Y[:n], 0.1)
    gt = tg.fit(tg.Gaussian(2.0, 1.0), torch.tensor(X[:n]), torch.tensor(Y[:n]), 0.1)
    gj, gt = jexact.extend(gj, X[n:], Y[n:]), tg.extend(gt, X[n:], Y[n:])
    _close(gt.L.numpy(), gj.L, 1e-10)
    _close(gt.alpha.numpy(), gj.alpha, 1e-10)
    gj, gt = jexact.shrink(gj, 2), tg.shrink(gt, 2)
    assert gt.num_samples == n + k - 2 and gt.route == "shrink"
    _close(gt.L.numpy(), gj.L, 1e-10)
    _close(gt.alpha.numpy(), gj.alpha, 1e-10)
    for a, b in zip(exact.loo_cv(gt), jexact.loo_cv(gj)):
        _close(a.numpy(), np.asarray(b), 1e-10)


def test_window_float32_narrow_against_jax(monkeypatch):
    monkeypatch.setenv("GPR_SOLVE_SCHEDULE", "narrow")
    n, k = 1024, 512
    X, Y = _window_data(n, k, np.float32, seed=6)
    solves = []
    orig = tsolve._narrow_impl
    monkeypatch.setattr(tsolve, "_narrow_impl", lambda *a: solves.append(a[1].shape[0]) or orig(*a))
    gt = tg.extend(tg.fit(tg.Gaussian(2.0, 1.0), torch.tensor(X[:n]), torch.tensor(Y[:n]), 0.1),
                   X[n:], Y[n:])
    assert solves == [n, n + k]  # alpha of the fit and of the extended window
    gj = jexact.extend(jexact.fit(jg.Gaussian(2.0, 1.0), X[:n], Y[:n], 0.1), X[n:], Y[n:])
    ref = tg.fit(tg.Gaussian(2.0, 1.0), torch.tensor(X, dtype=torch.float64),
                 torch.tensor(Y, dtype=torch.float64), float(np.float32(0.1)))
    assert _err(gt.alpha.numpy(), ref.alpha.numpy()) <= 3 * _err(gj.alpha, ref.alpha.numpy())
    for a, b, c in zip(exact.loo_cv(gt), jexact.loo_cv(gj), exact.loo_cv(ref)):
        assert _err(a.numpy(), c.numpy()) <= 3 * _err(np.asarray(b), c.numpy()) + 1e-7
    # the window slides: drop the oldest 512 and compare with a fresh fit
    gs = tg.shrink(gt, k)
    assert solves[-1] == n
    fresh = tg.fit(tg.Gaussian(2.0, 1.0), torch.tensor(X[k:], dtype=torch.float64),
                   torch.tensor(Y[k:], dtype=torch.float64), float(np.float32(0.1)))
    f32 = tg.fit(tg.Gaussian(2.0, 1.0), torch.tensor(X[k:]), torch.tensor(Y[k:]), 0.1)
    assert _err(gs.alpha.numpy(), fresh.alpha.numpy()) <= 3 * _err(f32.alpha.numpy(), fresh.alpha.numpy())
    assert _err(gs.L.numpy(), fresh.L.numpy()) <= 3 * _err(f32.L.numpy(), fresh.L.numpy())


def test_cholupdate_matches_jax_sequential_updates():
    rng = np.random.default_rng(7)
    m, k = 200, 3
    G = rng.standard_normal((m, m))
    L = np.linalg.cholesky(G @ G.T + m * np.eye(m))
    V = rng.standard_normal((m, k))
    Lj = jnp_asarray(L)
    for p in range(k):
        Lj = jexact._cholupdate(Lj, V[:, p])
    Lt = exact._cholupdate(torch.tensor(L), torch.tensor(V))
    _close(Lt.numpy(), np.asarray(Lj), 1e-12)
    _close(exact._cholupdate(torch.tensor(L), torch.tensor(V[:, 0])).numpy(),
           np.asarray(jexact._cholupdate(jnp_asarray(L), V[:, 0])), 1e-12)


@pytest.mark.parametrize("k", [1, 64])
def test_shrink_equals_a_fresh_fit(k):
    X, Y = _window_data(600, 0, np.float64, seed=8)
    gp = tg.fit(tg.Gaussian(1.5, 1.0), torch.tensor(X), torch.tensor(Y), 0.1)
    gs = tg.shrink(gp, k)
    fresh = tg.fit(tg.Gaussian(1.5, 1.0), torch.tensor(X[k:]), torch.tensor(Y[k:]), 0.1)
    _close(gs.L.numpy(), fresh.L.numpy(), 1e-12)
    _close(gs.alpha.numpy(), fresh.alpha.numpy(), 1e-10)
    with pytest.raises(ValueError):
        tg.shrink(gp, 600)
    with pytest.raises(ValueError):
        tg.shrink(tg.fit(tg.Gaussian(1.5, 1.0), torch.tensor(X), torch.tensor(Y), 0.1,
                         efficient_storage=True), 1)


def jnp_asarray(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def test_sample_posterior():
    X, Y, Xs = _entry_data(np.float64)
    gj = jexact.fit(_jax_kernel(np.float64), X, Y, sigma=0.1)
    gt = tg.fit(tg.parse_kernel(ENTRY_KERNEL), torch.tensor(X), torch.tensor(Y), sigma=0.1)
    pts = Xs[:6]
    mean, Lc = gt._posterior_factor(torch.tensor(pts))
    # JAX's sample_posterior before its draw (exact.py:128-134)
    from gpr_tpu.kernels import kernels as jkm
    from gpr_tpu.ops import linalg as jlin

    Ks = jkm.gram(gj.kernel, pts, gj.X)
    cov = jkm.gram(gj.kernel, pts) - Ks @ gj._core_solve(Ks.T)
    Lj, _ = jlin.safe_cholesky(0.5 * (cov + cov.T), initial_jitter=1e-10)
    _close(mean.numpy(), np.asarray(gj.predict(pts)), 1e-10)
    _close(Lc.numpy(), np.asarray(Lj), 1e-8)
    # the draws by their moments: S draws, q outputs share Lc
    S = 20000
    draws = gt.sample_posterior(torch.Generator().manual_seed(3), torch.tensor(pts), S)
    assert draws.shape == (S, 6, 4)
    sd = torch.sqrt(torch.diagonal(Lc @ Lc.T))
    z = (draws.mean(0) - mean) / (sd[:, None] / S ** 0.5)
    assert float(z.abs().max()) < 5.0  # within 5 standard errors
    C = torch.einsum("sip,sjp->ij", draws - mean, draws - mean) / (S * 4)
    assert float((C - Lc @ Lc.T).abs().max()) < 0.05 * float((Lc @ Lc.T).abs().max())
    jdraws = gj.sample_posterior(jax.random.PRNGKey(0), pts, 2000)
    assert np.asarray(jdraws).shape == (2000, 6, 4)


def test_predict_derivative_describe_inversion_error():
    X, Y, Xs = _entry_data(np.float64)
    gj = jexact.fit(jg.Gaussian(1.5, 1.0), X, Y, sigma=0.1)
    gt = tg.fit(tg.Gaussian(1.5, 1.0), torch.tensor(X), torch.tensor(Y), sigma=0.1)
    mt, Dt = gt.predict_derivative(torch.tensor(Xs[0]))
    mj, Dj = gj.predict_derivative(Xs[0])
    assert Dt.shape == (8, 4)
    _close(mt.numpy(), np.asarray(mj), 1e-10)
    _close(Dt.numpy(), np.asarray(Dj), 1e-10)
    assert gt.describe() == gj.describe()
    et, ej = float(gt.inversion_error()), float(gj.inversion_error())
    assert et < 1e-9 and ej < 1e-9


def test_equality_and_hash():
    X, Y, _ = _entry_data(np.float64)
    a = tg.fit(tg.parse_kernel(ENTRY_KERNEL), torch.tensor(X), torch.tensor(Y), sigma=0.1)
    b = tg.fit(tg.parse_kernel(ENTRY_KERNEL), torch.tensor(X), torch.tensor(Y), sigma=0.1)
    c = tg.fit(tg.parse_kernel(ENTRY_KERNEL), torch.tensor(X), torch.tensor(Y), sigma=0.2)
    d = tg.fit(tg.Sum(tg.Gaussian(1.5, 1.0), tg.White(0.2)), torch.tensor(X), torch.tensor(Y),
               sigma=0.1)
    assert a == b and a != c and a != d and a != "gp"
    assert hash(a) == id(a) and len({a, b}) == 2
    assert len(list(a.named_modules())) >= 3  # nn.Module machinery still hashes the model
    gj = jexact.fit(_jax_kernel(np.float64), X, Y, sigma=0.1)
    assert (gj == jexact.fit(_jax_kernel(np.float64), X, Y, sigma=0.1)) == (a == b)


def test_fit_schedule_switches_pick_jax_routes(monkeypatch):
    k = tg.Gaussian(1.5, 1.0)
    f32 = torch.float32
    assert exact.fit_route(k, 2048, f32, "cuda", True) == "fused-gram"
    # the default takes the fused Gram route wherever it applies (any n on
    # the card in float32), False keeps JAX's default, the matrix ladder
    assert exact.fit_route(k, 2048, f32, "cuda") == "fused-gram"
    assert exact.fit_route(k, 2048, f32, "cuda", False) == "fused-matrix"
    assert exact.fit_route(k, 3773, f32, "cuda") == "fused-gram"
    assert exact.fit_route(k, 3773, f32, "cuda", False) == "blocked-syrk"
    assert exact.fit_route(k, 3773, torch.float64, "cuda") == "blocked"
    assert exact.fit_route(k, 3773, f32, "cpu") == "blocked"
    assert exact.fit_route(k, 384, f32, "cuda") == "torch-cholesky"
    assert exact.fit_route(tg.Periodic(1.0, 1.0, 2.0), 2048, f32, "cuda") == "fused-matrix"
    monkeypatch.setenv("GPR_FIT_SCHEDULE", "twopass")  # exact.py:392: K1 + safe_cholesky
    assert exact.fit_route(k, 2048, f32, "cuda", True) == "gram-kernel"
    assert exact.fit_route(k, 2048, f32, "cuda") == "fused-matrix"
    monkeypatch.delenv("GPR_FIT_SCHEDULE")
    monkeypatch.setenv("GPR_CHOL_SCHEDULE", "recursive")  # exact.py:391, linalg.py:72-118
    assert exact.fit_route(k, 2048, f32, "cuda", True) == "gram-kernel"
    assert exact.fit_route(k, 2048, f32, "cuda") == "blocked-syrk"
    X = torch.tensor(np.random.default_rng(9).standard_normal((1024, 3)), dtype=f32)
    gp = tg.fit(k, X, X[:, :1], 0.1, use_pallas_gram=True)
    assert gp.route == "gram-kernel"


def test_breathing_check_protocol():
    # chip_smoke.py's standing check at the breathing-fixture shape, at a
    # small n on the CPU: each quantity's float32 error against float64,
    # beside the plain float32 route's, passes within 3x of it
    import json

    import chip_smoke

    rng = np.random.default_rng(4)
    X = rng.standard_normal((300, 5)).astype(np.float32)
    Y = (np.sin(X[:, :3]) + 0.1 * rng.standard_normal((300, 3))).astype(np.float32)
    Xs = torch.tensor(rng.standard_normal((40, 5)).astype(np.float32))
    X, Y = torch.tensor(X), torch.tensor(Y)
    gp = tg.fit(tg.Gaussian(2.0, 1.0), X, Y, 0.1)

    def kfun(A, B):
        return chip_smoke.gaussian64(A, B, 2.0, 1.0)

    sig = float(np.float32(0.1))
    gates = chip_smoke.fit_gates(gp, X, Y, Xs, kfun, 1.0, sig)
    assert set(gates) == {"mean", "credible_interval", "alpha"}
    assert json.loads(json.dumps(gates)) == gates
    for g in gates.values():
        assert g["ok"] and 0 < g["plain_f32_err"] < 1e-3 and g["limit"] == 3 * g["plain_f32_err"]
    # an alpha off by 1e-3 of itself is far outside 3x float32 rounding
    bad = exact.GP(gp.kernel, X, Y, gp.sigma, gp.alpha * 1.001, gp.L)
    assert not chip_smoke.fit_gates(bad, X, Y, Xs, kfun, 1.0, sig)["alpha"]["ok"]
