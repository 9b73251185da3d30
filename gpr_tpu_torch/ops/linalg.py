"""PSD-safe linear algebra: jitter-guarded Cholesky and the solves around it.

Mirrors gpr_tpu/ops/linalg.py:50-63 and 101-386 (``chol_lower`` at
101-118).  Every result is expressed through a Cholesky factor; no explicit
inverse is formed on the hot path.

The factorization route follows the tensor:

  ``"fused-matrix"``    CUDA float32, n >= 1024, n % 128 == 0: the
                        hand-written panel Cholesky (ops/fullchol.py, K2-K4),
                        as JAX takes its fused kernel for f32 n >= 1024.
  ``"blocked-syrk"``    CUDA float32, any other n >= 1024: the recursive
                        blocked Cholesky (ops/blocked.py) whose trailing
                        updates run the hand-written SYRK kernel K5, as JAX
                        takes blocked.py:208-281 with pallas_syrk.  K5 masks
                        its ragged edge, so the TPU's 512-alignment gate on
                        the SYRK (blocked.py:100-109) is dropped: every
                        float32 trailing update on the card runs K5.
  ``"blocked"``         float64, or a CPU tensor, n >= 1024: the same
                        recursion with a ``torch.matmul`` update in float64
                        and K5's plain version in float32.
  ``"blocked-syrk-leaf"``, ``"blocked-leaf"``
                        the two above under ``GPR_CHOL_LEAF_INV=1``: every
                        leaf with n % 256 == 0 factored with its inverse by
                        ``leaf_cholesky_wi`` (K13 on the card, its plain
                        version on the CPU; a float64 leaf on the card by
                        ``cholesky_ex``), the column solves by products with
                        the leaves' inverses (ops/blocked.py).
  ``"inplace"``         float32, n >= 1024, n % 512 == 0, under
                        ``GPR_CHOL_SCHEDULE=inplace``: the in-place
                        wide-panel schedule (ops/inplace_chol.py; K16-K18 on
                        the card, their plain versions on the CPU), as JAX
                        takes ``cholesky_inplace`` whatever its backend.
  ``"torch-cholesky"``  n < 1024 (and batches): ``torch.linalg.cholesky``, as
                        JAX uses ``jnp.linalg.cholesky`` there.

Every route reads only the lower triangle, and a failed factorization comes
back NaN at its last diagonal entry, so success is one O(1) check.

``GPR_CHOL_SCHEDULE`` is read at call time as JAX reads it at trace time
(linalg.py:72-118): ``fused`` (default) as above; any other value skips
``fused-matrix``, so ``recursive`` sends those matrices to ``blocked-syrk``;
``inplace`` sends float32 matrices with n % 512 == 0 to ``"inplace"`` and the
rest (float64, other n) to the blocked routes (linalg.py:84-114, 183-188).
``GPR_CHOL_LEAF_INV=1``, also read at call time, turns the blocked routes
into their ``-leaf`` forms, as JAX reads it inside ``cholesky_blocked``
(blocked.py:309-357); ``fused-matrix`` and ``inplace``, taken before the
blocked routes, do not read it, as JAX's fused and in-place kernels do not.

``safe_cholesky`` is a ``torch.autograd.Function``: its forward is the host
jitter loop over the route, its backward the Murray pullback from the
returned (jittered) factor, exactly 0 where that factor is NaN
(linalg.py:137-154, 166-290).

``cho_solve`` takes the narrow solve (ops/solve.py, kernels K10 and K11)
under ``GPR_SOLVE_SCHEDULE=narrow`` for a 2-D float32 factor with n >= 1024,
n % 512 == 0 and at most 128 right-hand sides (linalg.py:322-348); its route
is :func:`solve_route`.  Every other case, a wider right-hand side included,
takes two ``torch.linalg.solve_triangular``.  JAX takes its blocked solves
there for a 2-D factor with n >= 1024 (linalg.py:125-134, 334-346); the port
keeps cuBLAS's triangular solves, since on an H100 at n=16384
``ops.blocked.cho_solve_blocked`` was slower at q=128 and q=16384 and faster
only at q=8 (chip_smoke.py phase 30 (d); PERF.md).
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import torch

from ..utils.profiling import count, host_wait
from .blocked import _leaf_inverse_default, cholesky_blocked
from .fullchol import PANEL, cholesky_fused
from .inplace_chol import cholesky_inplace
from .solve import cho_solve_narrow, solve_narrow_usable

# log-space bounds of the reference's long-double determinant clamp
# (include/Likelihood.h:180-188), as gpr_tpu/ops/linalg.py:36-47
_LDBL_LOG_MAX = 11356.523406294143

# below this size JAX factors with its stock primitive (linalg.py:66-69)
BLOCKED_MIN_N = 1024


def add_diagonal(A: torch.Tensor, value) -> torch.Tensor:
    """A + value * I; ``value`` is a scalar or one value per batch element."""
    n = A.shape[-1]
    if not (isinstance(value, torch.Tensor) and value.device == A.device):
        host_wait("linalg.add_diagonal", A)  # a blocking copy to the card
    value = torch.as_tensor(value, dtype=A.dtype, device=A.device)
    if value.ndim:
        value = value[..., None, None]
    eye = torch.eye(n, dtype=torch.bool, device=A.device)
    return A + torch.where(eye, value, torch.zeros((), dtype=A.dtype, device=A.device))


def _chol_schedule() -> str:
    """``GPR_CHOL_SCHEDULE``, read at call time (linalg.py:72-81)."""
    return os.environ.get("GPR_CHOL_SCHEDULE", "fused")


def route_for(n: int, dtype: torch.dtype, device: torch.device, batched: bool = False) -> str:
    """The factorization route of an (n, n) matrix of this dtype and device."""
    if not batched and n >= BLOCKED_MIN_N:
        schedule = _chol_schedule()
        cuda_f32 = torch.device(device).type == "cuda" and dtype == torch.float32
        if cuda_f32 and n % PANEL == 0 and schedule == "fused":
            return "fused-matrix"
        if schedule == "inplace" and dtype == torch.float32 and n % 512 == 0:
            return "inplace"
        route = "blocked-syrk" if cuda_f32 else "blocked"
        return route + "-leaf" if _leaf_inverse_default() else route
    return "torch-cholesky"


def cholesky_route(A: torch.Tensor) -> str:
    """The factorization route :func:`safe_cholesky` takes for ``A``."""
    return route_for(A.shape[-1], A.dtype, A.device, batched=A.ndim != 2)


def _torch_cholesky(A: torch.Tensor) -> torch.Tensor:
    # NaN where the factorization failed, as jnp.linalg.cholesky returns it
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


_FACTOR = {
    "fused-matrix": cholesky_fused,
    "blocked-syrk": functools.partial(cholesky_blocked, leaf_inverse=False),
    "blocked": functools.partial(cholesky_blocked, leaf_inverse=False),
    "blocked-syrk-leaf": functools.partial(cholesky_blocked, leaf_inverse=True),
    "blocked-leaf": functools.partial(cholesky_blocked, leaf_inverse=True),
    "inplace": cholesky_inplace,
    "torch-cholesky": _torch_cholesky,
}


def chol_lower(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``A`` on its route (:func:`cholesky_route`),
    without jitter: NaN where it fails (linalg.py:101-118)."""
    return _FACTOR[cholesky_route(A)](A)


def _diag_ok(L: torch.Tensor) -> torch.Tensor:
    # a failed pivot propagates NaN to every later diagonal entry, so the
    # last one alone detects failure (linalg.py:157-163); per batch element
    return torch.isfinite(L[..., -1, -1])


def _all_ok(ok: torch.Tensor) -> bool:
    host_wait("linalg.ok", ok)
    return bool(ok.all())


def _safe_cholesky_forward(A, initial_jitter, max_tries):
    factor = _FACTOR[cholesky_route(A)]
    L = factor(A)
    count("factor.linalg")
    ok = _diag_ok(L)
    jitter = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    if _all_ok(ok):
        return L, jitter
    h = min(A.shape[-1], 1024)
    diag_mean = torch.diagonal(A[..., :h, :h], dim1=-2, dim2=-1).abs().mean(-1)
    eps = torch.finfo(A.dtype).eps
    if initial_jitter > 0:
        base = torch.full_like(diag_mean, initial_jitter)
    else:
        base = eps * torch.clamp(diag_mean, min=1.0)
    for tries in range(max_tries):
        jesc = base if tries == 0 else jitter * 10.0
        jitter = torch.where(ok, jitter, jesc)
        Lnew = factor(add_diagonal(A, jitter))
        count("factor.linalg")
        count("retry.linalg")
        L = torch.where(ok[..., None, None], L, Lnew)
        ok = ok | _diag_ok(Lnew)
        if _all_ok(ok):
            break
    return L, jitter


def _chol_pullback(L: torch.Tensor, Lbar: torch.Tensor) -> torch.Tensor:
    """Reverse-mode pullback of A -> L from the factor (Murray 2016):
    Abar = L^-T phi(L^T Lbar) L^-1, phi = tril with the diagonal halved,
    symmetrized as XLA's rule returns it (linalg.py:137-154).  One GEMM and
    two triangular solves."""
    M = torch.tril(L.mT @ torch.tril(Lbar))
    M.diagonal(dim1=-2, dim2=-1).mul_(0.5)
    P = torch.linalg.solve_triangular(L.mT, M, upper=True)           # L^-T M
    Abar = torch.linalg.solve_triangular(L, P, upper=False, left=False)  # P L^-1
    return 0.5 * (Abar + Abar.mT)


class _SafeCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, initial_jitter, max_tries):
        L, jitter = _safe_cholesky_forward(A, initial_jitter, max_tries)
        ctx.save_for_backward(L)
        ctx.mark_non_differentiable(jitter)
        return L, jitter

    @staticmethod
    def backward(ctx, Lbar, _jitter_bar):
        # L = chol(A + j(A) I) with j piecewise constant in A: the pullback
        # at the jittered point is the gradient, and the jitter gets none.
        # Exactly 0 where even the largest jitter failed (linalg.py:272-287).
        (L,) = ctx.saved_tensors
        if Lbar is None:
            return None, None, None
        okb = torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)[..., None, None]
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        zero = torch.zeros((), dtype=L.dtype, device=L.device)
        Abar = _chol_pullback(torch.where(okb, L, eye), torch.where(okb, Lbar, zero))
        return torch.where(okb, Abar, zero), None, None


def safe_cholesky(A: torch.Tensor, initial_jitter: float = 0.0,
                  max_tries: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, jitter): Cholesky of ``A + jitter I`` with jitter escalation,
    differentiable in ``A``.

    The first attempt is ``A`` itself; this is the whole success path (one
    factorization, one scalar read).  On failure the jitter starts at
    ``initial_jitter`` or eps * max(mean |diag(A)[:1024]|, 1), grows 10x per
    retry for at most ``max_tries`` retries, and only failed batch elements
    are retried.  A matrix that never factors comes back NaN, and its
    gradient is 0."""
    return _SafeCholesky.apply(A, float(initial_jitter), int(max_tries))


def _solve_schedule() -> str:
    """``GPR_SOLVE_SCHEDULE``, read at call time: 'blocked' (default) or
    'narrow' (linalg.py:322-329)."""
    return os.environ.get("GPR_SOLVE_SCHEDULE", "blocked")


def solve_route(L: torch.Tensor, b: torch.Tensor) -> str:
    """``"narrow"`` where :func:`cho_solve` takes the narrow solve for this
    factor and right-hand side, else ``"triangular"``.  A factor under
    ``torch.func.vmap`` (a fleet's per-member solve) stays triangular: the
    kernels take whole tensors."""
    if (L.ndim == 2 and L.shape[0] >= BLOCKED_MIN_N and _solve_schedule() == "narrow"
            and not torch._C._functorch.is_batchedtensor(L)):
        q = 1 if b.ndim == 1 else b.shape[-1]
        if solve_narrow_usable(L.shape[0], q, L.dtype, L.device):
            return "narrow"
    return "triangular"


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b with A = L L^T (see :func:`solve_route`)."""
    if solve_route(L, b) == "narrow":
        return cho_solve_narrow(L, b.to(L.dtype))
    squeeze = b.ndim == L.ndim - 1
    B = b[..., None] if squeeze else b
    y = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if squeeze else x


def _tri_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L X = B for lower-triangular L (linalg.py:125-134 with trans=False,
    the only form ``extend`` and ``loo_cv`` use), by cuBLAS's triangular
    solve at every n (see the module docstring)."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_psd(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    L, _ = safe_cholesky(A, initial_jitter=jitter)
    return cho_solve(L, b)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|A| from its factor, clamped like the reference clamps the
    determinant (include/Likelihood.h:180-188), in log space."""
    ld = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return torch.clamp(ld, -_LDBL_LOG_MAX, _LDBL_LOG_MAX)


def inv_psd(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Explicit PSD inverse through the factor: only for parity tests and the
    reference's CoreMatrix artifact (lib/GaussianProcess.cpp:152-153), never
    on the hot path."""
    L, _ = safe_cholesky(A, initial_jitter=jitter)
    return cho_solve(L, torch.eye(A.shape[-1], dtype=A.dtype, device=A.device))


def pinv(A: torch.Tensor, epsilon: Optional[float] = None) -> torch.Tensor:
    """SVD pseudo-inverse as the reference's ``gpr::pinv`` (include/Prior.h:
    38-56): singular values <= epsilon (default: the dtype's eps) are zeroed,
    not inverted."""
    if epsilon is None:
        epsilon = float(torch.finfo(A.dtype).eps)
    U, s, Vh = torch.linalg.svd(A, full_matrices=True)
    small = s <= epsilon
    s_inv = torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, s))
    k = s.shape[0]
    return (Vh.mT[:, :k] * s_inv[None, :]) @ U.mT[:k, :]


def symmetrize(A: torch.Tensor) -> torch.Tensor:
    return 0.5 * (A + A.mT)
