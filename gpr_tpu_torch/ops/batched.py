"""The fleet factorization: Cholesky and solves of B SPD matrices at once.

Mirrors gpr_tpu/ops/pallas_batched.py:306-773 (``batched_usable``,
``_diag_impl``, ``_crout_blocked_L``, ``diag_factor_inverse``,
``cholesky_batched``, ``cho_solve_batched``, ``factor_solve_fused``,
``factor_solve_batched_diff``, ``factor_solve_fused_diff`` and their
custom_vjp pullback), and, for the samplers' fleets, the per-member jitter
escalation of gpr_tpu/ops/linalg.py:166-290 (``factor_solve_safe``).

Two schedules.  The panel sweep, a right-looking sweep over all members at
once; per panel step k:

    L_kk, W_k = L_kk^-1         the diagonal scheme (``diag_factor_inverse``)
    P    = A_pk W_k^T           batched GEMM (the panel solve)
    A22 -= P P^T                batched GEMM (the trailing update)

and the fused fleet (``factor_solve_fused``): kernel K9 runs the same algebra
and the block substitution for every member in one launch, one CUDA block
per member.  Routes in gp/batched.py choose between them.

The diagonal scheme is read from ``GPR_FLEET_DIAG`` at call time, as in JAX
(pallas_batched.py:317-331); these names select which kernel runs, so they
carry over (ROADMAP ground rules):

    ``crout_xlaw``   (default) K7 crout_chol for L, then a batched triangular
                     solve against I for W, as JAX computes W outside Pallas;
    ``crout``        K8 crout_chol_wi: L and W in one launch;
    ``crout2<bs>``   L by K7 on (bs, bs) sub-blocks with batched GEMM
                     corrections (bs 32 when omitted), W by the triangular solve;
    ``xla``          ``torch.linalg.cholesky_ex`` (the library call where JAX
                     calls XLA's potrf), W by the triangular solve.

The GEMMs are ``torch.matmul`` / ``baddbmm`` at the port's IEEE FP32 tier
(utils/config.py).  Where JAX concatenates a tree of blocks, the panel sweep
factors one (B, n, n) buffer in place, as ops/blocked.py does: the diagonal
scheme writes each L_kk over its diagonal block.  The strict upper of every
result is exactly 0, and only the lower triangles of A are read.

The panels are the port's own (``PANEL``, ``FUSED_PANEL``); JAX's
(gp/batched.py:59-86, ``GPR_FLEET_PANEL``) are TPU tuning.  ``chip_smoke.py``
times the panel sweep at panels 32, 64 and 128 and the fused fleet at 64 and
128 (PERF.md).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..utils.profiling import count, host_wait
from . import _cuda, linalg
from .crout import crout_chol, crout_chol_wi, crout_chol_wi_reference

PANEL = 128
FUSED_PANEL = 64
FUSED_MAX_N = 2048  # csrc/fleet.cu: kFusedMaxN

# the fused fleet takes fleets with n <= this; 0 (the default) turns it off,
# as JAX reads GPR_FLEET_FUSED_MAX_N once at import (pallas_batched.py:648-650)
_FLEET_FUSED_MAX_N = int(os.environ.get("GPR_FLEET_FUSED_MAX_N", 0))
_FLEET_DIAG_DEFAULT = "crout_xlaw"


def _diag_impl() -> str:
    """The diagonal scheme, ``GPR_FLEET_DIAG`` read at call time."""
    return os.environ.get("GPR_FLEET_DIAG", _FLEET_DIAG_DEFAULT)


def batched_usable(n: int, dtype: torch.dtype, device) -> bool:
    """The hand-written fleet factorization applies to float32 fleets with
    panel-aligned n on the card (pallas_batched.py:306-314)."""
    return (dtype == torch.float32 and n % PANEL == 0 and n >= PANEL
            and torch.device(device).type == "cuda")


def _tri_inverse(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _crout_blocked_L(D: torch.Tensor, bs: int, out: torch.Tensor) -> torch.Tensor:
    """L = chol(D) of (B, p, p) SPD blocks into ``out`` by two-level blocking
    (pallas_batched.py:339-385): K7 on the (B, bs, bs) sub-blocks, batched
    GEMMs against the sub-blocks' inverses for the blocks below them."""
    p = D.shape[-1]
    if p <= bs:
        return crout_chol(D, out=out)
    S = torch.tril(D)
    for k in range(0, p, bs):
        e = min(k + bs, p)
        # the corrections of block column k from the columns before it
        if k:
            S[:, k:, k:e] -= torch.matmul(S[:, k:, :k], S[:, k:e, :k].mT)
        crout_chol(S[:, k:e, k:e], out=S[:, k:e, k:e])
        if e < p:
            S[:, e:, k:e] = torch.matmul(S[:, e:, k:e], _tri_inverse(S[:, k:e, k:e]).mT)
    return out.copy_(S.tril_())


def diag_factor_inverse(D: torch.Tensor, out: Optional[torch.Tensor] = None):
    """(L, W = L^-1) of a batch of SPD diagonal blocks (B, p, p), L into
    ``out`` (which may be ``D``), by the scheme :func:`_diag_impl` names
    (pallas_batched.py:388-409)."""
    impl = _diag_impl()
    if impl == "crout":
        return crout_chol_wi(D, L_out=out)
    if out is None:
        out = torch.empty_like(D, memory_format=torch.contiguous_format)
    if impl == "crout_xlaw":
        L = crout_chol(D, out=out)
    elif impl.startswith("crout2"):
        L = _crout_blocked_L(D, int(impl[6:] or 32), out)
    else:
        low = torch.tril(D)  # mirror the lower triangle: the upper may hold anything
        L, info = torch.linalg.cholesky_ex(low + torch.tril(low, -1).mT)
        # NaN where a block failed, as jax.lax.linalg.cholesky returns it
        L = out.copy_(torch.where((info != 0)[:, None, None], torch.nan, L))
    return L, _tri_inverse(L)


def cholesky_batched(A: torch.Tensor, *, panel: int = PANEL, return_winv: bool = False,
                     diag=diag_factor_inverse):
    """Lower Cholesky factors of a fleet ``A`` (B, n, n), n % panel == 0, by
    the panel sweep above (pallas_batched.py:412-462); ``diag(D, out=D)``
    factors the diagonal blocks.  With ``return_winv`` also the
    diagonal-block inverses W (B, n / panel, panel, panel), which
    :func:`cho_solve_batched` reuses.  A failed pivot leaves its member's
    L[-1, -1] non-finite; the other members are unaffected."""
    B, n, n2 = A.shape
    if n != n2 or n % panel or n == 0:
        raise ValueError(f"cholesky_batched: bad shape {tuple(A.shape)} for panel {panel}")
    nb = n // panel
    S = A.clone(memory_format=torch.contiguous_format)
    W = torch.empty((B, nb, panel, panel), dtype=A.dtype, device=A.device)
    for k in range(nb):
        s, e = k * panel, (k + 1) * panel
        D = S[:, s:e, s:e]
        _, Wk = diag(D, out=D)
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
    inverses are derived from L's diagonal blocks D as JAX does (479-506):
    under the ``xla`` scheme by a batched triangular solve against I, under
    every other by one K8 launch on the (B n / panel, panel, panel) tiles
    D D^T, since chol(D D^T) = D for a lower-triangular D with a positive
    diagonal.  Each block row's sum over the blocks already solved is one
    GEMM over their columns."""
    n = L.shape[-1]
    if n % panel:
        raise ValueError(f"cho_solve_batched: n={n} not a multiple of panel={panel}")
    nb = n // panel
    if winv is None:
        D = torch.stack([L[:, i * panel:(i + 1) * panel, i * panel:(i + 1) * panel]
                         for i in range(nb)], dim=1)
        if _diag_impl() == "xla":
            winv = _tri_inverse(D)
        else:
            DDt = torch.matmul(D, D.mT).reshape(-1, panel, panel)
            winv = crout_chol_wi(DDt)[1].reshape(D.shape)
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


def _wi_reference(D, out):
    L, W = crout_chol_wi_reference(D)
    return out.copy_(L), W


def factor_solve_fused_reference(A: torch.Tensor, Y: torch.Tensor, panel: int = FUSED_PANEL,
                                 return_winv: bool = False):
    """Plain torch version of K9, the ``_fleet_kernel`` algebra over all
    members at once (pallas_batched.py:575-639): the panel sweep with the
    plain with-W Crout sweep on every diagonal block, then the block
    substitution with those inverses."""
    _check_fused(A, Y, panel)
    L, W = cholesky_batched(A, panel=panel, return_winv=True, diag=_wi_reference)
    X = cho_solve_batched(L, Y, panel=panel, winv=W)
    return (L, X, W) if return_winv else (L, X)


def factor_solve_fused(A: torch.Tensor, Y: torch.Tensor, panel: int = FUSED_PANEL,
                       return_winv: bool = False):
    """K9: (L, alpha = A^-1 Y) of a fleet, A (B, n, n) SPD (lower triangles
    read), Y (B, n, q), in one launch (pallas_batched.py:653-689).  n %
    panel == 0, panel <= 128, n <= ``FUSED_MAX_N``.  With ``return_winv``
    also the diagonal-block inverses W (B, n / panel, panel, panel) the
    kernel computed on its way.  A CUDA tensor launches the kernel; a CPU
    tensor runs :func:`factor_solve_fused_reference`.  A failed pivot makes
    its member's L[-1, -1] and alpha NaN (non-finite in the plain version);
    the other members are unaffected."""
    _check_fused(A, Y, panel)
    if A.device.type == "cpu":
        return factor_solve_fused_reference(A, Y, panel, return_winv)
    B, n, _ = A.shape
    if A.dtype != torch.float32 or Y.dtype != torch.float32:
        raise ValueError(f"factor_solve_fused: the kernel takes float32, got {A.dtype}, {Y.dtype}")
    if panel > 128 or n > FUSED_MAX_N:
        raise ValueError(f"factor_solve_fused: panel {panel} > 128 or n {n} > {FUSED_MAX_N}")
    A, Y = A.contiguous(), Y.contiguous()
    L = torch.empty_like(A)
    X = torch.empty_like(Y)
    W = torch.empty((B, n // panel, panel, panel), dtype=A.dtype, device=A.device)
    _cuda.FLEET_FUSED.launch(A.device, A.data_ptr(), L.data_ptr(), Y.data_ptr(), X.data_ptr(),
                             W.data_ptr(), B, n, panel, Y.shape[-1])
    return (L, X, W) if return_winv else (L, X)


def _check_fused(A, Y, panel):
    if (A.ndim != 3 or A.shape[1] != A.shape[2] or Y.ndim != 3 or Y.shape[:2] != A.shape[:2]
            or 0 in Y.shape or panel < 1 or A.shape[1] % panel):
        raise ValueError(f"factor_solve_fused: bad shapes {tuple(A.shape)} {tuple(Y.shape)} "
                         f"for panel {panel}")
    if A.device.type not in ("cpu", "cuda") or Y.device != A.device:
        raise ValueError(f"factor_solve_fused: A on {A.device}, Y on {Y.device}")


def _fleet_pullback(L, W, alpha, Lbar, abar, panel):
    # alpha = K^-1 Y: Ybar = K^-1 abar, Kbar = chol_pullback(L, Lbar)
    # - sym(Ybar alpha^T); one more fleet solve, one batched GEMM and the
    # Murray pullback (pallas_batched.py:729-745)
    Ybar = cho_solve_batched(L, abar, panel=panel, winv=W)
    Ka = torch.matmul(Ybar, alpha.mT)
    return linalg._chol_pullback(L, Lbar) - 0.5 * (Ka + Ka.mT), Ybar


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
        L, W, alpha = ctx.saved_tensors
        return (*_fleet_pullback(L, W, alpha, Lbar, abar, ctx.panel), None)


class _FactorSolveFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, Y, panel):
        L, alpha = factor_solve_fused(K, Y, panel)
        ctx.save_for_backward(L, alpha)
        ctx.panel = panel
        return L, alpha

    @staticmethod
    def backward(ctx, Lbar, abar):
        # the inverses are re-derived from L, as JAX's _fsf_bwd does (768-770)
        L, alpha = ctx.saved_tensors
        return (*_fleet_pullback(L, None, alpha, Lbar, abar, ctx.panel), None)


def factor_solve_batched_diff(K: torch.Tensor, Y: torch.Tensor, panel: int = PANEL):
    """(L, alpha) of a fleet, K (B, n, n), Y (B, n, q): :func:`cholesky_batched`
    and :func:`cho_solve_batched`, differentiable in K and Y through the
    pullback above (pallas_batched.py:692-748)."""
    return _FactorSolveBatched.apply(K, Y, int(panel))


def factor_solve_fused_diff(K: torch.Tensor, Y: torch.Tensor, panel: int = FUSED_PANEL):
    """:func:`factor_solve_fused`, differentiable in K and Y through the same
    pullback, its fleet solve without the inverses (pallas_batched.py:751-773)."""
    return _FactorSolveFused.apply(K, Y, int(panel))


# ---------------------------------------------------------------------------
# the safe fleet factor: jitter escalation per member (linalg.py:166-290)
# ---------------------------------------------------------------------------

def _attempt(route: str, K: torch.Tensor, Y: torch.Tensor, panel: int):
    """(L, alpha, W or None) of one factorization of the fleet on ``route``
    (the names of gp/batched.py::fleet_route), without autograd."""
    if route == "fleet-crout":
        L, W = cholesky_batched(K, panel=panel, return_winv=True)
        return L, cho_solve_batched(L, Y, panel=panel, winv=W), W
    if route == "fleet-fused":
        L, alpha = factor_solve_fused(K, Y, panel)
        return L, alpha, None
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info != 0)[:, None, None], torch.nan, L)
    return L, torch.cholesky_solve(Y, L), None


def _escalate(route, K, Y, panel, initial_jitter, max_tries):
    """The forward of :func:`factor_solve_safe`: one attempt on the whole
    fleet, then up to ``max_tries`` retries of the members whose last
    diagonal entry is not finite, with JAX's schedule (linalg.py:197-263):
    ``initial_jitter`` or eps * max(mean |diag(K)[:1024]|, 1) on the first
    retry, 10x on every later one.  The retries factor the failed members
    alone, on the same route; each member's jitter stays once it factors.
    Counted by member: ``factor.fleet`` the members factored (the fleet, then
    each retry's), ``retry.fleet`` the members retried."""
    L, alpha, W = _attempt(route, K, Y, panel)
    count("factor.fleet", K.shape[0])
    ok = torch.isfinite(L[:, -1, -1])
    jitter = torch.zeros(K.shape[0], dtype=K.dtype, device=K.device)
    if _all_ok(ok):  # the success path: one factorization, one read
        return L, alpha, W, jitter, ok, True
    h = min(K.shape[-1], 1024)
    diag_mean = torch.diagonal(K[:, :h, :h], dim1=-2, dim2=-1).abs().mean(-1)
    if initial_jitter > 0:
        base = torch.full_like(diag_mean, initial_jitter)
    else:
        base = torch.finfo(K.dtype).eps * torch.clamp(diag_mean, min=1.0)
    for tries in range(max_tries):
        host_wait("fleet.nonzero", ok)  # the failed members' count is read
        idx = torch.nonzero(~ok).squeeze(1)
        count("factor.fleet", idx.shape[0])
        count("retry.fleet", idx.shape[0])
        jitter[idx] = base[idx] if tries == 0 else jitter[idx] * 10.0
        Ln, an, Wn = _attempt(route, linalg.add_diagonal(K[idx], jitter[idx]), Y[idx], panel)
        L[idx], alpha[idx] = Ln, an
        if W is not None:
            W[idx] = Wn
        ok[idx] = torch.isfinite(Ln[:, -1, -1])
        if _all_ok(ok):
            return L, alpha, W, jitter, ok, True
    return L, alpha, W, jitter, ok, False


def _all_ok(ok: torch.Tensor) -> bool:
    host_wait("fleet.ok", ok)
    return bool(ok.all())


def _route_solve(route, L, B, panel, W):
    if route == "torch-cholesky":
        return torch.cholesky_solve(B, L)
    # the fused route re-derives the inverses from L, one K8 launch (768-770)
    return cho_solve_batched(L, B, panel=panel, winv=W)


class _FactorSolveSafe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, Y, route, panel, initial_jitter, max_tries):
        L, alpha, W, jitter, ok, all_ok = _escalate(route, K, Y, panel, initial_jitter, max_tries)
        ctx.save_for_backward(L, alpha, ok, *(() if W is None else (W,)))
        ctx.route, ctx.panel, ctx.all_ok = route, panel, all_ok
        ctx.mark_non_differentiable(jitter)
        return L, alpha, jitter

    @staticmethod
    def backward(ctx, Lbar, abar, _jitter_bar):
        L, alpha, ok, *W = ctx.saved_tensors
        W = W[0] if W else None
        # the pullback at the jittered point (the jitter is piecewise
        # constant in K), exactly 0 for a member that never factored
        # (linalg.py:272-287): its factor is replaced by I before the solves
        if not ctx.all_ok:
            okb = ok[:, None, None]
            eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
            L = torch.where(okb, L, eye)
            alpha, Lbar, abar = (torch.where(okb, t, 0.0) for t in (alpha, Lbar, abar))
            if W is not None:
                W = torch.where(ok[:, None, None, None], W, torch.eye(W.shape[-1], dtype=W.dtype,
                                                                      device=W.device))
        Ybar = _route_solve(ctx.route, L, abar, ctx.panel, W)
        Ka = torch.matmul(Ybar, alpha.mT)
        Kbar = linalg._chol_pullback(L, Lbar) - 0.5 * (Ka + Ka.mT)
        if not ctx.all_ok:
            Kbar, Ybar = torch.where(okb, Kbar, 0.0), torch.where(okb, Ybar, 0.0)
        return Kbar, Ybar, None, None, None, None


def factor_solve_safe(K: torch.Tensor, Y: torch.Tensor, route: str, panel: int = PANEL,
                      initial_jitter: float = 0.0, max_tries: int = 6):
    """(L, alpha, jitter) of a fleet K (B, n, n), Y (B, n, q) on ``route``
    (``fleet-crout``, ``fleet-fused`` or ``torch-cholesky``) with JAX's
    per-member jitter escalation (``safe_cholesky`` on a batch,
    linalg.py:166-290): only members whose factor fails are retried, on the
    same route, and a member that never factors comes back NaN with an
    exactly-zero gradient.  Differentiable in K and Y; where every member
    factors at once, the factor, alpha and the pullback are those of the
    route's own functions (:func:`factor_solve_batched_diff`,
    :func:`factor_solve_fused_diff`) on the same inputs.  Each attempt reads
    ``ok.all()`` on the host once; the success path is one attempt."""
    return _FactorSolveSafe.apply(K, Y, route, int(panel), float(initial_jitter), int(max_tries))
