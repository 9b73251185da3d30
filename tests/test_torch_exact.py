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

import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from __graft_entry__ import _make_dataset
from gpr_tpu.gp import exact as jexact
from gpr_tpu_torch import convert

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
