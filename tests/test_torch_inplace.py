"""The port's in-place Cholesky (gpr_tpu_torch.ops.inplace_chol: K16-K18's
plain versions and the schedule) and the route ``"inplace"`` under
GPR_CHOL_SCHEDULE=inplace, against gpr_tpu on the CPU, where the JAX package
runs its Pallas kernels in interpret mode (about 2.5 s a factorization at
n = 1024).

The same numpy inputs (seeded) go through both packages, in float32, the
only dtype the schedule takes.  Tolerances: a factor or a tile update 1e-5
relative to its largest entry (as tests/test_torch_leaf.py holds the leaf
kernels; both sides sum in float32 in other orders, the port's plain
versions by cholesky_ex and triangular solves, JAX's by strip factors and
inverse products); JAX's own bound for the rank update, 2e-2 absolute against
float64.  K16's order on the card (per 128x128 sub-tile, one partial per
32-deep slice folded into a float32 running tile, then S -= run) is
emulated here in float32 torch and held to JAX's kernel at the same 1e-5.  The slice as a whole (fit -> predict / credible interval, MLL value
+ gradient) runs at sigma 0.1, where K's condition number turns the two
float32 computations' rounding into differences of ~2e-3 in alpha and ~1e-2
in the gradient between the packages; there each result of each package is
held against the port's float64 fit, and the port's error must be within 3x
JAX's (the accuracy protocol of ADVICE.md:5); that float64 fit and MLL are
held in turn against JAX's float64 ones at 1e-9 relative, so a fault shared
by the reference cannot pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
from gpr_tpu.gp import likelihood as jlk
from gpr_tpu.ops import inplace_chol as jic
from gpr_tpu.ops import linalg as jlin
import gpr_tpu_torch as tg
from gpr_tpu_torch.gp import likelihood as tlk
from gpr_tpu_torch.ops import _cuda, inplace_chol as ic, linalg

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _spd(n, seed):
    G = np.random.default_rng(seed).standard_normal((n, n))
    return (G @ G.T + n * np.eye(n)).astype(np.float32)


def _junk_upper(A, value):
    A = np.array(A)
    A[np.triu_indices(A.shape[0], 1)] = value
    return A


@pytest.fixture
def inplace_switch(monkeypatch):
    """Both packages under GPR_CHOL_SCHEDULE=inplace; JAX's caches cleared on
    both sides, as it reads the switch when it traces."""
    monkeypatch.setenv("GPR_CHOL_SCHEDULE", "inplace")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_rank_update_on_jax_lists():
    # tests/test_ops.py:805-823: targets (2,2), (3,2), (3,3) of 256, two
    # contraction tiles; the whole target tile, diagonal tiles included
    S = np.random.default_rng(1).standard_normal((1024, 1024)).astype(np.float32)
    rows, cols, kcols = (np.asarray(a, np.int32) for a in ([2, 3, 3], [2, 2, 3], [0, 1]))
    out_j = np.asarray(jic.rank_update_inplace(jnp.asarray(S), rows, cols, kcols, bm=256, bk=256,
                                               interpret=True))
    St = torch.tensor(S)
    out = ic.rank_update_inplace(St, rows, cols, kcols, bm=256, bk=256)
    assert out is St  # in place
    ref = S.astype(np.float64)
    P = ref[:, :512].copy()
    for i, j in [(2, 2), (3, 2), (3, 3)]:
        ref[i * 256:(i + 1) * 256, j * 256:(j + 1) * 256] -= P[i * 256:(i + 1) * 256] @ P[j * 256:(j + 1) * 256].T
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-2)
    assert _rel(out.numpy(), out_j) < TOL
    rest = np.ones(S.shape, bool)
    for i, j in [(2, 2), (3, 2), (3, 3)]:
        rest[i * 256:(i + 1) * 256, j * 256:(j + 1) * 256] = False
    np.testing.assert_array_equal(out.numpy()[rest], S[rest])  # nothing else is touched


def _k16_order(S, rows, cols, kcols, bm, bk, sub=128, k=32):
    """csrc/inplace.cu's K16 in float32 torch: every target tile cut into
    128x128 sub-tiles, each summed over the contiguous kcols by one partial
    per 32-deep slice, folded into a float32 running tile, then subtracted."""
    S = S.clone()
    assert list(kcols) == list(range(kcols[0], kcols[0] + len(kcols)))  # one run
    src = S[:, kcols[0] * bk:(kcols[-1] + 1) * bk].clone()
    for i, j in zip(rows, cols):
        for a in range(0, bm, sub):
            for b in range(0, bm, sub):
                A = src[i * bm + a:i * bm + a + sub]
                B = src[j * bm + b:j * bm + b + sub]
                run = torch.zeros((sub, sub))
                for k0 in range(0, src.shape[1], k):
                    run += A[:, k0:k0 + k] @ B[:, k0:k0 + k].T
                S[i * bm + a:i * bm + a + sub, j * bm + b:j * bm + b + sub] -= run
    return S


@pytest.mark.parametrize("lists", ["jax", "narrow", "wide"])
def test_k16_order_matches_jax(lists):
    # JAX's lists at n = 1024; the schedule's first narrow and wide lists at 2048
    n = 1024 if lists == "jax" else 2048
    S = np.random.default_rng(6).standard_normal((n, n)).astype(np.float32)
    if lists == "jax":
        rows, cols, kcols, bm = [2, 3, 3], [2, 2, 3], [0, 1], 256
    else:
        st = [s_ for s_ in ic.schedule(n, 512, 256, torch.device("cpu")) if s_[0] == "update"]
        _, r, c, kc, bm = st[0] if lists == "narrow" else st[1]
        rows, cols, kcols = r.tolist(), c.tolist(), kc.tolist()
        assert bm == (256 if lists == "narrow" else 512)
    out = _k16_order(torch.tensor(S), rows, cols, kcols, bm, bm).numpy()
    out_j = np.asarray(jic.rank_update_inplace(jnp.asarray(S), *(np.asarray(a, np.int32) for a in (rows, cols, kcols)),
                                               bm=bm, bk=bm, interpret=True))
    assert _rel(out, out_j) < TOL
    rest = np.ones(S.shape, bool)
    for i, j in zip(rows, cols):
        rest[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm] = False
    np.testing.assert_array_equal(out[rest], S[rest])


@pytest.mark.parametrize("c0t", [0, 1])
def test_panel_inplace_matches_jax(c0t):
    # the panel's diagonal tile is read from its lower triangle: junk above it
    A = _spd(1024, seed=5)
    S = np.array(A)
    e = (c0t + 1) * 256
    S[c0t * 256:e, c0t * 256:e] = _junk_upper(S[c0t * 256:e, c0t * 256:e], 1234.0)
    out_j = np.asarray(jic.panel_inplace(jnp.asarray(S), c0t, interpret=True))
    out = ic.panel_inplace(torch.tensor(S), c0t).numpy()
    panel = np.s_[c0t * 256:, c0t * 256:e]
    assert _rel(out[panel], out_j[panel]) < TOL
    assert np.all(np.triu(out[c0t * 256:e, c0t * 256:e], 1) == 0)
    rest = np.ones(S.shape, bool)
    rest[panel] = False
    np.testing.assert_array_equal(out[rest], S[rest])  # only the panel is rewritten


def test_zero_upper_matches_jax():
    S = _junk_upper(np.random.default_rng(2).standard_normal((1536, 1536)).astype(np.float32), np.nan)
    out_j = np.asarray(jic.zero_upper_inplace(jnp.asarray(S), interpret=True))
    out = ic.zero_upper_inplace(torch.tensor(S)).numpy()
    np.testing.assert_array_equal(out, out_j)
    np.testing.assert_array_equal(out, np.tril(np.nan_to_num(S, nan=7.0)))


@pytest.mark.parametrize("n", [512, 1024, 2048])
def test_cholesky_inplace_matches_jax(n):
    A = _spd(n, seed=n)
    Lj = np.asarray(jic.cholesky_inplace(jnp.asarray(A), interpret=True))
    At = torch.tensor(A)
    L = ic.cholesky_inplace(At)
    assert L.data_ptr() != At.data_ptr() and np.array_equal(At.numpy(), A)  # one defensive copy
    assert L.dtype == torch.float32 and np.all(np.triu(L.numpy(), 1) == 0)
    assert _rel(L, Lj) < TOL
    assert _rel(L, np.linalg.cholesky(A.astype(np.float64))) < TOL
    # reads the lower triangle only (JAX's test_reads_lower_only)
    for junk in (np.nan, 1234.0):
        np.testing.assert_array_equal(ic.cholesky_inplace(torch.tensor(_junk_upper(A, junk))).numpy(),
                                      L.numpy())


def test_schedule_lists_and_gate():
    steps = ic.schedule(16384, 512, 256, torch.device("cpu"))
    kinds = [s[0] for s in steps]
    assert kinds.count("panel") == 64 and kinds.count("update") == 63
    assert sum(1 for s in steps if s[0] == "update" and s[4] == 512) == 31
    assert ic.schedule(16384, 512, 256, torch.device("cpu")) is steps  # built once
    _cuda.reset_launch_counts()
    ic.cholesky_inplace(torch.tensor(_spd(1024, seed=3)))
    assert sum(_cuda.launch_counts().values()) == 0  # the plain versions on the CPU
    for n, w, b in ((1536, 1024, 256), (1280, 512, 256), (1024, 512, 384)):
        with pytest.raises(ValueError, match="n%w==0"):
            ic.cholesky_inplace(torch.eye(n), w=w, b=b)
    with pytest.raises(ValueError, match="coordinates"):
        ic.rank_update_inplace(torch.zeros(512, 512), [2], [0], [0], bm=256, bk=256)


@pytest.mark.parametrize("rows, cols, kcols", [([2], [0], [0]), ([-1], [0], [0]), ([1], [0], [2]),
                                               ([1, 1], [0], [0])])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_rank_update_checks_its_lists(rows, cols, kcols, as_tensor):
    # coordinates outside [0, n / bm) or rows and cols of two lengths raise,
    # int32 tensors on S's device as well as host lists; S is left as it was
    S = torch.ones(512, 512)
    args = [torch.tensor(a, dtype=torch.int32) if as_tensor else a for a in (rows, cols, kcols)]
    with pytest.raises(ValueError, match="coordinates|one length"):
        ic.rank_update_inplace(S, *args, bm=256, bk=256)
    assert bool(torch.all(S == 1))


def test_failed_pivot_poisons_the_factor():
    A = _spd(1024, seed=4)
    A[700, 700] = -A[700, 700]
    L = ic.cholesky_inplace(torch.tensor(A))
    assert np.isnan(float(L[-1, -1]))


def test_safe_cholesky_under_the_switch(inplace_switch):
    # tests/test_ops.py:875-898: the factor, and a singular matrix escalates
    # its jitter to a finite factor, in both packages alike
    A = _spd(1024, seed=11)
    At = torch.tensor(A)
    assert linalg.cholesky_route(At) == "inplace"
    L, jit = linalg.safe_cholesky(At)
    Lj, jitj = jlin.safe_cholesky(jnp.asarray(A))
    assert float(jit) == 0.0 and float(jitj) == 0.0
    assert _rel(L, np.asarray(Lj)) < TOL
    bad = np.zeros((1024, 1024), np.float32)
    Lb, jb = linalg.safe_cholesky(torch.tensor(bad))
    Lbj, jbj = jlin.safe_cholesky(jnp.asarray(bad))
    assert float(jb) > 0.0 and float(jb) == float(jbj)
    assert bool(torch.isfinite(Lb).all()) and _rel(Lb, np.asarray(Lbj)) < TOL


def _data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    Y = (np.sin(X[:, :3]) + 0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    return X, Y, rng.standard_normal((16, 5)).astype(np.float32)


@pytest.mark.parametrize("n", [1024, 2048])
def test_slice_under_the_switch(n, inplace_switch, monkeypatch):
    X, Y, Xs = _data(n, seed=n)
    tk, jk = tg.Gaussian(2.0, 1.0), jg.parse_kernel("GaussianKernel(2,1,)")
    calls, port_calls = [], []
    orig, port_orig = jic.cholesky_inplace, ic.cholesky_inplace
    monkeypatch.setattr(jic, "cholesky_inplace", lambda M, **kw: calls.append(M.shape[0]) or orig(M, **kw))
    monkeypatch.setitem(linalg._FACTOR, "inplace",
                        lambda M: port_calls.append((M.shape[0], M.dtype)) or port_orig(M))
    with jax.enable_x64(False):  # JAX's float32 path: its parameters in float32 too
        gj = jg.fit(jk, X, Y, sigma=0.1)
        jax_out = {"L": np.tril(np.asarray(gj.L)), "alpha": gj.alpha, "mean": gj.predict(Xs),
                   "credible_interval": gj.credible_interval(Xs)}
        jax_out["mll value"], jax_out["mll gradient"] = jlk.mll_value_and_grad(jk, X, Y, 0.1)
    assert calls and set(calls) == {n}  # JAX took its in-place schedule
    _cuda.reset_launch_counts()
    gp = tg.fit(tk, X, Y, sigma=0.1, device="cpu")
    assert gp.route == "inplace" and tlk.factor_route(torch.tensor(X)) == "inplace"
    port = {"L": gp.L, "alpha": gp.alpha, "mean": gp.predict(torch.tensor(Xs)),
            "credible_interval": gp.credible_interval(torch.tensor(Xs))}
    port["mll value"], port["mll gradient"] = tlk.mll_value_and_grad(tk, X, Y, 0.1, device="cpu")
    assert sum(_cuda.launch_counts().values()) == 0
    assert port_calls == [(n, torch.float32)] * 2  # one factorization for the fit, one for the MLL
    X64, Y64, Xs64 = (torch.tensor(a, dtype=torch.float64) for a in (X, Y, Xs))
    g64 = tg.fit(tk, X64, Y64, sigma=0.1, device="cpu")
    ref = {"L": g64.L, "alpha": g64.alpha, "mean": g64.predict(Xs64),
           "credible_interval": g64.credible_interval(Xs64)}
    ref["mll value"], ref["mll gradient"] = tlk.mll_value_and_grad(tk, X64, Y64, 0.1, device="cpu")
    # the float64 reference itself, against JAX's float64 fit and MLL (x64, the
    # suite's default; float64 takes JAX's blocked route): 1e-9 relative
    X64n, Y64n, Xs64n = (a.astype(np.float64) for a in (X, Y, Xs))
    gj64 = jg.fit(jk, X64n, Y64n, sigma=0.1)
    indep = {"L": np.tril(np.asarray(gj64.L)), "alpha": gj64.alpha, "mean": gj64.predict(Xs64n),
             "credible_interval": gj64.credible_interval(Xs64n)}
    indep["mll value"], indep["mll gradient"] = jlk.mll_value_and_grad(jk, X64n, Y64n, 0.1)
    for key, r in ref.items():
        assert np.asarray(indep[key]).dtype == np.float64, key
        assert _rel(r.detach(), indep[key]) <= 1e-9, (key, _rel(r.detach(), indep[key]))
    for key, r in ref.items():
        # the port's hyperparameters are float64, as JAX's under x64: so is the gradient
        assert port[key].dtype == (torch.float64 if key == "mll gradient" else torch.float32), key
        e_port, e_jax = _rel(port[key].detach(), r.detach()), _rel(jax_out[key], r.detach())
        assert e_port <= 3 * e_jax, (key, e_port, e_jax)
