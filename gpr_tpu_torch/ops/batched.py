"""The fleet factorization: Cholesky and solves of B SPD matrices at once.

Mirrors gpr_tpu/ops/pallas_batched.py:306-545 (``batched_usable``,
``diag_factor_inverse``, ``cholesky_batched``, ``cho_solve_batched``) and
692-748 (``factor_solve_batched_diff`` and its custom_vjp).

A right-looking panel sweep over all members at once.  Per panel step k:

    L_kk = chol(D_k)            K7 crout_chol on the (B, p, p) diagonal blocks
    W_k  = L_kk^-1              torch.linalg.solve_triangular against I, as JAX
                                computes W outside Pallas (its default
                                ``crout_xlaw`` diagonal scheme, pallas_batched.py:331)
    P    = A_pk W_k^T           batched GEMM (the panel solve)
    A22 -= P P^T                batched GEMM (the trailing update)

The GEMMs are ``torch.matmul`` / ``baddbmm`` at the port's IEEE FP32 tier
(utils/config.py).  Where JAX concatenates a tree of blocks, the port factors
one (B, n, n) buffer in place, as ops/blocked.py does: K7 writes each L_kk
over its diagonal block.  The strict upper of the result is exactly 0, and
only the lower triangles of A are read.

The panel is the port's own (``PANEL``); JAX's 32 / 64 (gp/batched.py:76-86)
is TPU tuning.  ``chip_smoke.py`` times the fleet fit at panels 32, 64 and
128; 128 was the fastest at B=128, n=512 on the H100 (PERF.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import linalg
from .crout import crout_chol

PANEL = 128


def batched_usable(n: int, dtype: torch.dtype, device) -> bool:
    """The hand-written fleet factorization applies to float32 fleets with
    panel-aligned n on the card (pallas_batched.py:306-314)."""
    return (dtype == torch.float32 and n % PANEL == 0 and n >= PANEL
            and torch.device(device).type == "cuda")


def diag_factor_inverse(D: torch.Tensor, out: Optional[torch.Tensor] = None):
    """(L, W = L^-1) of a batch of SPD diagonal blocks (B, p, p): K7 for L
    (into ``out``, which may be ``D``), then a batched triangular solve
    against I for W (pallas_batched.py:388-409, the ``crout_xlaw`` scheme)."""
    L = crout_chol(D, out=out)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device).expand(L.shape)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def cholesky_batched(A: torch.Tensor, *, panel: int = PANEL, return_winv: bool = False):
    """Lower Cholesky factors of a fleet ``A`` (B, n, n), n % panel == 0, by
    the panel sweep above (pallas_batched.py:412-462).  With
    ``return_winv`` also the diagonal-block inverses W (B, n / panel, panel,
    panel), which :func:`cho_solve_batched` reuses.  A failed pivot leaves
    its member's L[-1, -1] NaN; the other members are unaffected."""
    B, n, n2 = A.shape
    if n != n2 or n % panel or n == 0:
        raise ValueError(f"cholesky_batched: bad shape {tuple(A.shape)} for panel {panel}")
    nb = n // panel
    S = A.clone(memory_format=torch.contiguous_format)
    W = torch.empty((B, nb, panel, panel), dtype=A.dtype, device=A.device)
    for k in range(nb):
        s, e = k * panel, (k + 1) * panel
        D = S[:, s:e, s:e]
        _, Wk = diag_factor_inverse(D, out=D)
        W[:, k] = Wk
        if e < n:
            P = torch.matmul(S[:, e:, s:e], W[:, k].mT)
            S[:, e:, s:e] = P
            S[:, e:, e:].baddbmm_(P, P.mT, alpha=-1.0)
    S.tril_()
    return (S, W) if return_winv else S


def cho_solve_batched(L: torch.Tensor, Bmat: torch.Tensor, *, panel: int = PANEL,
                      winv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve (L L^T) X = Bmat for a fleet, L (B, n, n), Bmat (B, n, q), by the
    block substitution with the diagonal-block inverses ``winv``
    (pallas_batched.py:465-545): batched GEMMs only.  Without ``winv`` the
    inverses come from a batched triangular solve of L's diagonal blocks
    against I (JAX's ``xla`` branch, 486-493).  Each block row's sum over
    the blocks already solved is one GEMM over their columns."""
    n = L.shape[-1]
    if n % panel:
        raise ValueError(f"cho_solve_batched: n={n} not a multiple of panel={panel}")
    nb = n // panel
    if winv is None:
        D = torch.stack([L[:, i * panel:(i + 1) * panel, i * panel:(i + 1) * panel]
                         for i in range(nb)], dim=1)
        eye = torch.eye(panel, dtype=L.dtype, device=L.device).expand(D.shape)
        winv = torch.linalg.solve_triangular(D, eye, upper=False)
    Bmat = Bmat.to(L.dtype)
    Y = torch.empty_like(Bmat)
    # forward: y_i = W_i (b_i - L[i, :i] y[:i])
    for i in range(nb):
        s, e = i * panel, (i + 1) * panel
        rhs = Bmat[:, s:e]
        if i:
            rhs = torch.baddbmm(rhs, L[:, s:e, :s], Y[:, :s], alpha=-1.0)
        Y[:, s:e] = torch.matmul(winv[:, i], rhs)
    # backward: x_i = W_i^T (y_i - L[i+1:, i]^T x[i+1:]), in place over y
    for i in range(nb - 1, -1, -1):
        s, e = i * panel, (i + 1) * panel
        rhs = Y[:, s:e]
        if e < n:
            rhs = torch.baddbmm(rhs, L[:, e:, s:e].mT, Y[:, e:], alpha=-1.0)
        Y[:, s:e] = torch.matmul(winv[:, i].mT, rhs)
    return Y


class _FactorSolveBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, Y, panel):
        L, W = cholesky_batched(K, panel=panel, return_winv=True)
        alpha = cho_solve_batched(L, Y, panel=panel, winv=W)
        ctx.save_for_backward(L, W, alpha)
        ctx.panel = panel
        return L, alpha

    @staticmethod
    def backward(ctx, Lbar, abar):
        # alpha = K^-1 Y: Ybar = K^-1 abar, Kbar = chol_pullback(L, Lbar)
        # - sym(Ybar alpha^T); one more fleet solve, one batched GEMM and
        # the Murray pullback (pallas_batched.py:729-745)
        L, W, alpha = ctx.saved_tensors
        Ybar = cho_solve_batched(L, abar, panel=ctx.panel, winv=W)
        Ka = torch.matmul(Ybar, alpha.mT)
        Kbar = linalg._chol_pullback(L, Lbar) - 0.5 * (Ka + Ka.mT)
        return Kbar, Ybar, None


def factor_solve_batched_diff(K: torch.Tensor, Y: torch.Tensor, panel: int = PANEL):
    """(L, alpha) of a fleet, K (B, n, n), Y (B, n, q): :func:`cholesky_batched`
    and :func:`cho_solve_batched`, differentiable in K and Y through the
    pullback above (pallas_batched.py:692-748)."""
    return _FactorSolveBatched.apply(K, Y, int(panel))
