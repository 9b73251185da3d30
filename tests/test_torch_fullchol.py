"""The port's panel Cholesky (gpr_tpu_torch.ops.fullchol: K2-K4's plain
versions) against gpr_tpu.ops.pallas_fullchol in interpret mode and against
float64 numpy.  Mirrors tests/test_fullchol.py:60-274.

Tolerances are test_fullchol.py's: 3e-3 relative for a factor and 2e-3 for a
Gram-mode reconstruction, set by the TPU kernel's bf16x3 tier (the port's
float32 is tighter); matern12 2e-2 for its r -> 0 cusp.  Where both packages
run the same float32 steps on identical inputs the bounds are tighter and
stated in place.
"""

import numpy as np
import pytest
import torch

from gpr_tpu.ops import pallas_fullchol as jfc
from gpr_tpu_torch.ops import fullchol as tfc
from torch_split_order import cholesky_lookahead, cholesky_split, panel_update_split

F32 = np.float32
TPU_KW = dict(panel=128, block=64, sw=16, interpret=True)  # test_fullchol.py's small config


def _spd(rng, n):
    B = rng.standard_normal((n, n)).astype(F32)
    return B @ B.T + n * np.eye(n, dtype=F32)


def _ref_gram(X, form, sigma, scale, diag, third=2.0):
    X64 = X.astype(np.float64)
    sq = ((X64[:, None, :] - X64[None, :, :]) ** 2).sum(-1)
    r = np.sqrt(sq)
    if form == "gaussian":
        K = scale**2 * np.exp(-0.5 * sq / sigma**2)
    elif form == "matern12":
        K = scale**2 * np.exp(-r / sigma)
    elif form == "matern32":
        a = np.sqrt(3.0) * r / sigma
        K = scale**2 * (1 + a) * np.exp(-a)
    elif form == "matern52":
        a = np.sqrt(5.0) * r / sigma
        K = scale**2 * (1 + a + a * a / 3.0) * np.exp(-a)
    else:  # rq
        K = scale**2 * (1 + 0.5 * sq / (sigma**2 * third)) ** (-third)
    return K + diag * np.eye(len(X))


def _gram_ref(X, form="gaussian", sigma=1.3, scale=2.1, third=2.0, diag=1.0):
    L, W = tfc.fused_cholesky_reference(torch.tensor(X), form=form, sigma=sigma, scale=scale,
                                        third=third, diag=diag)
    return L.numpy(), W.numpy()


class TestMatrixMode:
    @pytest.mark.parametrize("n", [128, 256, 384])  # single panel, two, odd count
    def test_matches_pallas_and_numpy(self, rng, n):
        A = _spd(rng, n)
        L, _ = tfc.fused_cholesky_reference(torch.tensor(A))
        L = L.numpy()
        Lr = np.linalg.cholesky(A.astype(np.float64))
        scale = np.abs(Lr).max()
        assert np.abs(L - Lr).max() / scale < 3e-3
        Lj = np.asarray(jfc.cholesky_fused(A, **TPU_KW))
        assert np.abs(L - Lj).max() / scale < 3e-3
        assert np.all(np.triu(L, 1) == 0.0)  # exact-zero strict upper

    def test_reads_only_the_lower_triangle(self, rng):
        A = _spd(rng, 256)
        B = A.copy()
        B[np.triu_indices(256, 1)] = np.nan
        L1 = tfc.cholesky_fused(torch.tensor(A)).numpy()
        L2 = tfc.cholesky_fused(torch.tensor(B)).numpy()
        np.testing.assert_array_equal(L1, L2)

    @pytest.mark.parametrize("where", [3, 250])  # first panel, last panel
    def test_failed_pivot_poisons_last_diagonal(self, rng, where):
        A = _spd(rng, 256)
        A[where, where] = -1e6
        L, W = tfc.fused_cholesky_reference(torch.tensor(A))
        assert not np.isfinite(L[-1, -1].item())
        assert not np.isfinite(W[-1].numpy()).all()


class TestGramMode:
    @pytest.mark.parametrize("form", tfc.GRAM_FORMS)
    def test_recon_matches_f64_gram(self, rng, form):
        X = rng.standard_normal((256, 3)).astype(F32)
        L, _ = _gram_ref(X, form)
        K = _ref_gram(X, form, 1.3, 2.1, 1.0)
        err = np.abs(L @ L.T - K).max() / np.abs(K).max()
        assert err < (2e-2 if form == "matern12" else 2e-3), f"{form}: recon rel err {err}"

    def test_matches_pallas(self, rng):
        X = rng.standard_normal((256, 3)).astype(F32)
        L, W = _gram_ref(X)
        Lj, Wj = jfc.gram_cholesky_fused(X, 1.3, 2.1, 1.0, 1.0, form="gaussian",
                                         return_winv=True, **TPU_KW)
        assert np.abs(L - np.asarray(Lj)).max() / np.abs(L).max() < 3e-3
        assert np.abs(W - np.asarray(Wj)).max() / np.abs(W).max() < 3e-3

    def test_single_panel(self, rng):
        X = rng.standard_normal((128, 3)).astype(F32)
        L, W = _gram_ref(X)
        assert L.shape == (128, 128) and W.shape == (1, 128, 128)
        K = _ref_gram(X, "gaussian", 1.3, 2.1, 1.0)
        assert np.abs(L @ L.T - K).max() / np.abs(K).max() < 2e-3

    def test_winv_emission_and_panel_solve(self, rng):
        n, q = 512, 3
        X = torch.tensor(rng.standard_normal((n, 6)).astype(F32))
        B = torch.tensor(rng.standard_normal((n, q)).astype(F32))
        L, W, jit = tfc.safe_gram_cholesky_fused(X, 1.5, 1.2, 1.0, 0.3, return_winv=True)
        assert float(jit) == 0.0
        for j in range(W.shape[0]):
            Lj = L[j * 128:(j + 1) * 128, j * 128:(j + 1) * 128]
            assert (W[j] @ Lj - torch.eye(128)).abs().max() < 1e-3
            assert torch.all(torch.triu(W[j], 1) == 0.0)
        x = tfc.cho_solve_panels(L, W, B).numpy()
        Lr = L.numpy().astype(np.float64)
        ref = np.linalg.solve(Lr @ Lr.T, B.numpy().astype(np.float64))
        assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-4
        # the same sweeps as the JAX package on identical inputs: float32
        # products in another order, 1e-5
        xj = np.asarray(jfc.cho_solve_panels(L.numpy(), W.numpy(), B.numpy()))
        assert np.abs(x - xj).max() / np.abs(xj).max() < 1e-5
        x1 = tfc.cho_solve_panels(L, W, B[:, 0]).numpy()
        np.testing.assert_allclose(x1, x[:, 0], rtol=0, atol=1e-6 * np.abs(x).max())


class TestPaddedN:
    @pytest.mark.parametrize("n", [200, 300])
    def test_padded_gram_factor(self, rng, n):
        X = rng.standard_normal((n, 3)).astype(F32)
        sigma, scale, diag = 1.3, 2.1, 0.7
        Lp, _ = _gram_ref(X, sigma=sigma, scale=scale, diag=diag)
        n_pad = -(-n // 128) * 128
        assert Lp.shape == (n_pad, n_pad)
        K = _ref_gram(X, "gaussian", sigma, scale, diag)
        L = Lp[:n, :n]
        assert np.abs(L @ L.T - K).max() / np.abs(K).max() < 2e-3
        # pad rows: exactly zero cross block, sqrt(scale^2 + diag) diagonal
        assert np.all(Lp[n:, :n] == 0.0)
        assert np.abs(np.diag(Lp)[n:] - np.sqrt(scale**2 + diag)).max() < 1e-5
        if n == 300:
            Lj = np.asarray(jfc.gram_cholesky_fused(X, sigma, scale, 1.0, diag, form="gaussian",
                                                    **TPU_KW))
            assert np.abs(Lp - Lj).max() / np.abs(Lj).max() < 3e-3

    def test_padded_fit_solve(self, rng):
        n, q = 300, 2
        X = rng.standard_normal((n, 4)).astype(F32)
        Y = rng.standard_normal((n, q)).astype(F32)
        L, W, jit = tfc.safe_gram_cholesky_fused(torch.tensor(X), 1.5, 1.2, 1.0, 0.3,
                                                 return_winv=True)
        Yp = torch.zeros((L.shape[0], q))
        Yp[:n] = torch.tensor(Y)
        alpha = tfc.cho_solve_panels(L, W, Yp).numpy()
        assert np.all(alpha[n:] == 0.0)  # decoupled pad tail
        K = _ref_gram(X, "gaussian", 1.5, 1.2, 0.3)
        ref = np.linalg.solve(K, Y.astype(np.float64))
        assert np.abs(alpha[:n] - ref).max() / np.abs(ref).max() < 5e-3
        assert float(jit) == 0.0

    def test_padded_matches_aligned_prefix(self, rng):
        # the first panel sees identical inputs with and without padding
        X = rng.standard_normal((256, 3)).astype(F32)
        Lfull, _ = _gram_ref(X[:256], diag=0.5)
        Lpad, _ = _gram_ref(X[:200], diag=0.5)
        assert np.array_equal(Lfull[:128, :128], Lpad[:128, :128])


class TestSafeWrapper:
    def test_zero_jitter_on_clean_input(self, rng):
        X = torch.tensor(rng.standard_normal((256, 3)).astype(F32))
        L, j = tfc.safe_gram_cholesky_fused(X, 1.3, 2.1, 1.0, 1e-2)
        assert torch.isfinite(L).all()
        assert float(j) == 0.0

    def test_escalates_on_duplicates(self, rng):
        X = rng.standard_normal((384, 3)).astype(F32)
        X[7] = X[3]
        X[100] = X[3]  # exactly singular K at zero noise
        L, j = tfc.safe_gram_cholesky_fused(torch.tensor(X), 1.3, 2.1, 1.0, 0.0)
        L = L.numpy()
        assert np.isfinite(L).all()
        assert float(j) > 0.0
        K = _ref_gram(X, "gaussian", 1.3, 2.1, float(j))
        assert np.abs(L @ L.T - K).max() / np.abs(K).max() < 2e-3


class TestSplitK:
    """K2's split plan (ops/fullchol.py::_split_plan, _split_pieces) and the
    plain version that sums in its order (tests/torch_split_order.py).  The split sums are float32
    products of 128-deep slices added in another order than one product:
    1e-5 of the factor's largest entry against the one-product reference,
    and the file's 3e-3 against JAX's Pallas kernel."""

    @staticmethod
    def _block_of(u, units, blocks):  # csrc/fullchol.cu::panel_strip_kernel's formula
        return ((u + 1) * blocks - 1) // units

    @pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
    @pytest.mark.parametrize("n_pad", [128, 256, 384, 1024, 4096, 8192, 16384])
    def test_plan_covers_every_k_once_in_whole_fold_slices(self, n_pad, sms):
        # the products' pieces cover k < jp - 128, dealt out to all SMs but
        # one; the last slice [jp - 128, jp) follows as a piece of its own
        for j in range(n_pad // tfc.PANEL):
            blocks = tfc._split_plan(n_pad, j, sms)
            tiles = (n_pad - j * tfc.PANEL) // tfc.PANEL
            if j == 0:
                assert blocks == 0 and tfc._scratch_tiles(n_pad, j, sms) == 0
                continue
            ks = j - 1
            assert blocks == (min(ks * tiles, sms - 1) if ks else 0)
            pieces = tfc._split_pieces(n_pad, j, blocks)
            s0 = blocks + tiles - 1 if blocks else 0
            slots, work = [], [0] * blocks
            for t, ps in enumerate(pieces):
                k = 0
                for slot, lo, hi in ps:  # contiguous, in order: every k once
                    assert lo == k and hi > lo and lo % tfc.PANEL == 0 and hi % tfc.PANEL == 0
                    k = hi
                assert k == j * tfc.PANEL
                assert ps[-1] == (s0 + t, ks * tfc.PANEL, j * tfc.PANEL)  # the last slice, last
                for slot, lo, hi in ps[:-1]:
                    work[slot - t] += (hi - lo) // tfc.PANEL
                if blocks:
                    first = self._block_of(t * ks, tiles * ks, blocks)
                    last = self._block_of((t + 1) * ks - 1, tiles * ks, blocks)
                    assert [slot - t for slot, _, _ in ps[:-1]] == list(range(first, last + 1))
                slots += [slot for slot, _, _ in ps]
            assert len(set(slots)) == len(slots)  # no two pieces share a slot
            assert max(slots) < tfc._scratch_tiles(n_pad, j, sms)
            assert not work or max(work) - min(work) <= 1  # every block the same work, to one slice
        most = max(tfc._scratch_tiles(n_pad, j, sms) for j in range(n_pad // tfc.PANEL))
        assert (most == 0) == (n_pad == 128)  # one panel has no update

    def test_scratch_is_bounded(self):
        n_pad = 16384
        most = max(tfc._scratch_tiles(n_pad, j, 132) for j in range(n_pad // tfc.PANEL))
        assert most <= 131 + 2 * 127
        assert most * tfc.PANEL * tfc.PANEL * 4 <= 25.3e6
        for j in (64, 100, 120, 127):  # the late panels still fill the card but one SM
            tiles = (n_pad - j * tfc.PANEL) // tfc.PANEL
            assert tfc._split_plan(n_pad, j, 132) == min((j - 1) * tiles, 131)

    def test_forced_block_counts_agree(self, rng):
        A = torch.tensor(_spd(rng, 1024))
        L, _ = tfc.fused_cholesky_reference(A)
        j = 5
        Lj = L.clone()
        Lj[:, j * 128:] = 0.0
        base = Lj.clone()
        tfc.panel_update_reference(base, j, A)
        for blocks in (1, 2, 3, 7, 12):  # 12: one block a slice below jp - 128
            out = Lj.clone()
            panel_update_split(out, j, A, blocks=blocks)
            assert _relerr(out, base) < 1e-5, blocks

    @pytest.mark.parametrize("n", [384, 1024])
    def test_split_order_matrix_mode(self, rng, n):
        A = _spd(rng, n)
        L, W = cholesky_split(torch.tensor(A))
        L1, W1 = tfc.fused_cholesky_reference(torch.tensor(A))
        assert _relerr(L, L1) < 1e-5 and _relerr(W, W1) < 1e-5
        assert torch.all(torch.triu(L, 1) == 0.0)
        Lj = np.asarray(jfc.cholesky_fused(A, **TPU_KW))
        assert np.abs(L.numpy() - Lj).max() / np.abs(Lj).max() < 3e-3

    @pytest.mark.parametrize("n", [384, 1024])
    def test_split_order_gram_mode(self, rng, n):
        X = rng.standard_normal((n, 3)).astype(F32)
        kw = dict(form="gaussian", sigma=1.3, scale=2.1, diag=1.0)
        L, W = cholesky_split(torch.tensor(X), "gaussian", 1.3, 2.1, 1.0, 1.0)
        L1, W1 = tfc.fused_cholesky_reference(torch.tensor(X), **kw)
        assert _relerr(L, L1) < 1e-5 and _relerr(W, W1) < 1e-5
        Lj, Wj = jfc.gram_cholesky_fused(X, 1.3, 2.1, 1.0, 1.0, form="gaussian",
                                         return_winv=True, **TPU_KW)
        Lj, Wj = np.asarray(Lj), np.asarray(Wj)
        assert np.abs(L.numpy() - Lj).max() / np.abs(Lj).max() < 3e-3
        assert np.abs(W.numpy() - Wj).max() / np.abs(Wj).max() < 3e-3


class TestLookahead:
    """The card's one-panel lookahead (ops/fullchol.py::_lookahead) in its
    order with the plain versions (tests/torch_split_order.py::
    cholesky_lookahead): the next panel's products are summed before this
    panel's K3 and K4 write its columns.  They read only finished columns,
    so L is bit-identical to the split order run panel by panel, and within
    the file's 3e-3 of JAX's Pallas kernel."""

    @pytest.mark.parametrize("mode,n", [("matrix", 384), ("matrix", 1024), ("gram", 1024),
                                        ("gram", 300), ("gram", 1000)])
    def test_lookahead_order_matches_pallas(self, rng, mode, n):
        if mode == "matrix":
            src = _spd(rng, n)
            gram = ()
            Lj = np.asarray(jfc.cholesky_fused(src, **TPU_KW))
        else:
            src = rng.standard_normal((n, 3)).astype(F32)
            gram = ("gaussian", 1.3, 2.1, 1.0, 1.0)
            Lj = np.asarray(jfc.gram_cholesky_fused(src, 1.3, 2.1, 1.0, 1.0, form="gaussian",
                                                    **TPU_KW))
        L, W = cholesky_lookahead(torch.tensor(src), *gram)
        L1, W1 = cholesky_split(torch.tensor(src), *gram)
        assert torch.equal(L, L1) and torch.equal(W, W1)
        assert torch.all(torch.triu(L, 1) == 0.0)
        assert np.abs(L.numpy() - Lj).max() / np.abs(Lj).max() < 3e-3


def _relerr(a, b):
    return float((a - b).abs().max() / b.abs().max())
