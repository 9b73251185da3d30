"""The fused fleet and the fleet's diagonal schemes (gpr_tpu_torch.ops.batched,
gp.batched route ``fleet-fused``) against gpr_tpu's (ops/pallas_batched.py,
gp/batched.py, its Pallas kernels in interpret mode), on the CPU.

Both packages get the same numpy inputs.  Tolerances: float32 factors,
inverses and solves of the same algorithm agree to 1e-5 of their largest
entry (sums in other orders; cond(A) ~ 10 for these G G^T + n I); a solve
through inverses taken from chol(D D^T), as JAX's fleet solve without W
does, gets 1e-4 against float64 (the squared condition of D); float64 values
agree to 1e-10 relative and gradients to 1e-9, traces of 20 Adam steps to
1e-8 (as tests/test_torch_batched.py).

JAX's Pallas sweeps compile one unrolled program per tile width, which in
interpret mode takes minutes and tens of GiB at n = 256, panel 128.  So JAX
runs its fused kernel here at panel 16 (``GPR_FLEET_PANEL``, which the port
does not read; its panel is its own), and the port's fused fleet at
(3, 256, 4) is held to a float64 solve instead.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
import gpr_tpu_torch as tg
from gpr_tpu.gp import batched as jb
from gpr_tpu.ops import pallas_batched as jpb
from gpr_tpu_torch.gp import batched as tb
from gpr_tpu_torch.ops import _cuda
from gpr_tpu_torch.ops import batched as tob


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _spd(B, n, seed):
    G = np.random.default_rng(seed).standard_normal((B, n, n))
    return (G @ G.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _junk_upper(A):
    junk = A.copy()
    iu = np.triu_indices(A.shape[-1], 1)
    junk[:, iu[0], iu[1]] = np.nan
    return junk


@pytest.fixture
def fused_on(monkeypatch):
    """Both packages' fused fleet on for n <= 512; JAX at panel 16."""
    monkeypatch.setattr(jpb, "_FLEET_FUSED_MAX_N", 512)
    monkeypatch.setattr(tob, "_FLEET_FUSED_MAX_N", 512)
    monkeypatch.setenv("GPR_FLEET_PANEL", "16")


def test_factor_solve_fused_matches_pallas_interpret():
    A = _spd(3, 128, 1)
    A[1, 100, 100] = -1e4  # member 1 fails in its last panel
    Y = np.random.default_rng(2).standard_normal((3, 128, 2)).astype(np.float32)
    junk = _junk_upper(A)
    Lj, Xj = (np.asarray(v) for v in jpb.factor_solve_fused(jnp.asarray(junk), jnp.asarray(Y),
                                                            panel=16, interpret=True))
    _cuda.reset_launch_counts()
    Lt, Xt = tob.factor_solve_fused(torch.tensor(junk), torch.tensor(Y), 16)
    assert _cuda.launch_counts()["fleet_fused"] == 0  # a CPU tensor runs the plain version
    ok = [0, 2]
    assert _rel(Lt[ok], Lj[ok]) < 1e-5 and _rel(Xt[ok], Xj[ok]) < 1e-5
    truth = np.linalg.solve(A[ok].astype(np.float64), Y[ok].astype(np.float64))
    assert _rel(Xt[ok], truth) < 1e-5
    assert not np.isfinite(Lj[1, -1, -1]) and not torch.isfinite(Lt[1, -1, -1])
    assert not np.isfinite(Xj[1]).all() and not torch.isfinite(Xt[1]).all()
    # JAX's pivot-pair step scales its masked columns after the mask, so the
    # failed block's strict upper comes out NaN (0 * inf); the port's is 0
    assert not torch.triu(Lt, 1).any() and not np.triu(Lj[ok], 1).any()
    assert np.isnan(np.triu(Lj[1], 1)).any()
    # the port's own panel gives the same factor
    Lp, Xp = tob.factor_solve_fused(torch.tensor(A[ok]), torch.tensor(Y[ok]))
    assert _rel(Lp, Lj[ok]) < 1e-5 and _rel(Xp, Xj[ok]) < 1e-5


@pytest.mark.parametrize("panel", [64, 128])
def test_factor_solve_fused_at_n_256(panel):
    A = _spd(3, 256, 3)
    Y = np.random.default_rng(4).standard_normal((3, 256, 4)).astype(np.float32)
    L, X, W = tob.factor_solve_fused(torch.tensor(_junk_upper(A)), torch.tensor(Y), panel,
                                     return_winv=True)
    L0, X0 = tob.factor_solve_fused(torch.tensor(A), torch.tensor(Y), panel)
    torch.testing.assert_close(L, L0, rtol=0, atol=0)  # the lower triangle only is read
    torch.testing.assert_close(X, X0, rtol=0, atol=0)
    A64 = A.astype(np.float64)
    assert _rel(L, np.linalg.cholesky(A64)) < 1e-5
    assert _rel(X, np.linalg.solve(A64, Y.astype(np.float64))) < 1e-5
    assert W.shape == (3, 256 // panel, panel, panel)
    for k in range(256 // panel):
        D = L[:, k * panel:(k + 1) * panel, k * panel:(k + 1) * panel]
        assert float((W[:, k] @ D - torch.eye(panel)).abs().max()) < 1e-5
    assert not torch.triu(L, 1).any()


@pytest.mark.parametrize("impl,p", [("crout", 32), ("crout_xlaw", 32), ("crout2", 64),
                                    ("xla", 32)])
def test_diag_factor_inverse_schemes_match_jax(monkeypatch, impl, p):
    monkeypatch.setenv("GPR_FLEET_DIAG", impl)
    D = _spd(4, p, 5)
    Lj, Wj = (np.asarray(v) for v in jpb.diag_factor_inverse(jnp.asarray(D), interpret=True))
    _cuda.reset_launch_counts()
    Lt, Wt = tob.diag_factor_inverse(torch.tensor(_junk_upper(D)))  # the lower triangle only
    assert sum(_cuda.launch_counts().values()) == 0
    assert _rel(Lt, Lj) < 1e-5 and _rel(Wt, Wj) < 1e-5
    assert not torch.triu(Lt, 1).any() and not torch.triu(Wt, 1).any()
    assert _rel(Lt, np.linalg.cholesky(D.astype(np.float64))) < 1e-5


@pytest.mark.parametrize("impl", [None, "xla"])
def test_cho_solve_without_inverses_takes_jax_branch(monkeypatch, impl):
    """With no W, JAX's default scheme inverts L's diagonal blocks D through
    crout_chol_wi(D D^T) (pallas_batched.py:494-506); the port's follows."""
    if impl:
        monkeypatch.setenv("GPR_FLEET_DIAG", impl)
    else:
        monkeypatch.delenv("GPR_FLEET_DIAG", raising=False)
    A = _spd(2, 64, 6)
    L = np.linalg.cholesky(A.astype(np.float64)).astype(np.float32)
    Bm = np.random.default_rng(7).standard_normal((2, 64, 3)).astype(np.float32)
    Xj = np.asarray(jpb.cho_solve_batched(jnp.asarray(L), jnp.asarray(Bm), panel=32,
                                          interpret=True))
    Xt = tob.cho_solve_batched(torch.tensor(L), torch.tensor(Bm), panel=32)
    truth = np.linalg.solve(A.astype(np.float64), Bm.astype(np.float64))
    assert _rel(Xt, Xj) < 1e-5 and _rel(Xt, truth) < 1e-4


def test_fit_and_mll_on_the_fused_branch_match_jax(fused_on):
    """tests/test_batched.py:39-66 in both packages: the fused branch's value
    and gradient, and its fit."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((2, 64, 3))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.05 * rng.standard_normal((2, 64, 2))
    fj = jb.fit_batched(jg.Gaussian(1.2, 0.9), jnp.asarray(X), jnp.asarray(Y), sigma=0.5,
                        use_crout=True)
    _cuda.reset_launch_counts()
    ft = tb.fit_batched(tg.Gaussian(1.2, 0.9), X, Y, 0.5, use_crout=True, device="cpu")
    assert ft.route == "fleet-fused" and sum(_cuda.launch_counts().values()) == 0
    assert _rel(ft.L, fj.L) < 1e-10 and _rel(ft.alpha, fj.alpha) < 1e-10

    def jloss(p):
        return jnp.sum(jb.mll_batched(jg.Gaussian(p[0], p[1]), jnp.asarray(X), jnp.asarray(Y),
                                      0.2, batched_kernel=True, use_crout=True))

    p0 = np.array([[1.7, 1.1], [0.9, 1.3]])
    vj, gj = jax.value_and_grad(jloss)(jnp.asarray(p0))
    grads = []
    for use_crout in (True, False):
        p = torch.tensor(p0, requires_grad=True)
        mt = tb.mll_batched(tg.Gaussian(p[0], p[1]), X, Y, 0.2, batched_kernel=True,
                            use_crout=use_crout, device="cpu")
        (gt,) = torch.autograd.grad(mt.sum(), p)
        assert abs(float(mt.detach().sum()) - float(vj)) <= 1e-10 * abs(float(vj))
        assert _rel(gt, gj) < 1e-9
        grads.append(gt)
    assert _rel(grads[0], grads[1]) < 1e-9  # the fused branch against torch's


def test_fit_mle_batched_fused_trace_matches_jax(fused_on):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((2, 32, 1))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.05 * rng.standard_normal((2, 32, 2))
    init = np.array([[0.6, 1.0], [2.5, 0.8]])
    kw = dict(iterations=20, learning_rate=0.05, use_crout=True)
    _, rj = jb.fit_mle_batched(jg.Gaussian(1.0, 1.0), jnp.asarray(X), jnp.asarray(Y), 0.1,
                               init=jnp.asarray(init), **kw)
    _, rt = tb.fit_mle_batched(tg.Gaussian(1.0, 1.0), X, Y, 0.1, init=init, device="cpu", **kw)
    assert rt.route == "fleet-fused"
    assert _rel(rt.trace, rj.trace) < 1e-8 and _rel(rt.params, rj.params) < 1e-8
    assert abs(rt.value - rj.value) <= 1e-8 * abs(rj.value)


def test_defaults_leave_the_fused_fleet_off(monkeypatch):
    monkeypatch.delenv("GPR_FLEET_DIAG", raising=False)
    assert tob._diag_impl() == "crout_xlaw" == jpb._FLEET_DIAG_DEFAULT
    assert tob._FLEET_FUSED_MAX_N == int(os.environ.get("GPR_FLEET_FUSED_MAX_N", 0))
    if "GPR_FLEET_FUSED_MAX_N" not in os.environ:
        assert tob._FLEET_FUSED_MAX_N == 0
        assert tb.fleet_route(512, torch.float32, "cuda") == "fleet-crout"
    monkeypatch.setattr(tob, "_FLEET_FUSED_MAX_N", 1024)
    assert tb.fleet_route(512, torch.float32, "cuda") == "fleet-fused"
    assert tb.fleet_route(1536, torch.float32, "cuda") == "fleet-crout"
    assert tb.fleet_route(512, torch.float32, "cpu") == "torch-cholesky"
    assert tb.fleet_route(512, torch.float64, "cpu", use_crout=True) == "fleet-fused"
    src = (_cuda.CSRC / "fleet.cu").read_text()
    assert f"constexpr int kFusedMaxN = {tob.FUSED_MAX_N};" in src


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    A = torch.eye(64).expand(2, 64, 64).contiguous()
    Y = torch.ones((2, 64, 1))
    with pytest.raises(ValueError):
        tob.factor_solve_fused(A[0], Y)  # not (B, n, n)
    with pytest.raises(ValueError):
        tob.factor_solve_fused(A, Y[:1])  # Y's fleet differs
    with pytest.raises(ValueError):
        tob.factor_solve_fused(A, torch.ones((2, 64, 0)))  # no right-hand side
    with pytest.raises(ValueError):
        tob.factor_solve_fused(A, Y, 48)  # panel does not divide n
    with pytest.raises(ValueError):
        tob.factor_solve_fused(A.to("meta"), Y.to("meta"))  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        tob.factor_solve_fused_reference(A, Y.double().to("meta"))
