"""PSD-safe linear algebra: jitter-guarded Cholesky and the solves around it.

Mirrors gpr_tpu/ops/linalg.py:50-63 and 157-358 (forward only; the Murray
pullback of ``safe_cholesky`` comes with the likelihood).  Every result is
expressed through a Cholesky factor; no explicit inverse is formed.

The factorization route follows the tensor:

  ``"fused-matrix"``       CUDA float32, n >= 1024, n % 128 == 0: the
                           hand-written panel Cholesky (ops/fullchol.py, K2-K4),
                           as JAX takes its fused kernel for f32 n >= 1024.
  ``"cusolver-unported"``  any other n >= 1024: ``torch.linalg.cholesky``
                           standing in for JAX's blocked + SYRK route
                           (blocked.py:208-262), which is not ported yet (on a
                           CPU tensor the same call runs LAPACK).
  ``"torch-cholesky"``     n < 1024: ``torch.linalg.cholesky``, as JAX uses
                           ``jnp.linalg.cholesky`` there.

Every route reads only the lower triangle, and a failed factorization comes
back NaN at its last diagonal entry, so success is one O(1) check.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .fullchol import PANEL, cholesky_fused

# log-space bounds of the reference's long-double determinant clamp
# (include/Likelihood.h:180-188), as gpr_tpu/ops/linalg.py:36-47
_LDBL_LOG_MAX = 11356.523406294143

# below this size JAX factors with its stock primitive (linalg.py:66-69)
BLOCKED_MIN_N = 1024


def add_diagonal(A: torch.Tensor, value) -> torch.Tensor:
    """A + value * I; ``value`` is a scalar or one value per batch element."""
    n = A.shape[-1]
    value = torch.as_tensor(value, dtype=A.dtype, device=A.device)
    if value.ndim:
        value = value[..., None, None]
    eye = torch.eye(n, dtype=torch.bool, device=A.device)
    return A + torch.where(eye, value, torch.zeros((), dtype=A.dtype, device=A.device))


def cholesky_route(A: torch.Tensor) -> str:
    """The factorization route :func:`safe_cholesky` takes for ``A``."""
    n = A.shape[-1]
    if A.ndim == 2 and n >= BLOCKED_MIN_N:
        if A.device.type == "cuda" and A.dtype == torch.float32 and n % PANEL == 0:
            return "fused-matrix"
        return "cusolver-unported"
    return "torch-cholesky"


def _torch_cholesky(A: torch.Tensor) -> torch.Tensor:
    # NaN where the factorization failed, as jnp.linalg.cholesky returns it
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _diag_ok(L: torch.Tensor) -> torch.Tensor:
    # a failed pivot propagates NaN to every later diagonal entry, so the
    # last one alone detects failure (linalg.py:157-163); per batch element
    return torch.isfinite(L[..., -1, -1])


def safe_cholesky(A: torch.Tensor, initial_jitter: float = 0.0,
                  max_tries: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, jitter): Cholesky of ``A + jitter I`` with jitter escalation.

    The first attempt is ``A`` itself; this is the whole success path (one
    factorization, one scalar read).  On failure the jitter starts at
    ``initial_jitter`` or eps * max(mean |diag(A)[:1024]|, 1), grows 10x per
    retry for at most ``max_tries`` retries, and only failed batch elements
    are retried.  A matrix that never factors comes back NaN."""
    factor = cholesky_fused if cholesky_route(A) == "fused-matrix" else _torch_cholesky
    L = factor(A)
    ok = _diag_ok(L)
    jitter = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    if bool(ok.all()):
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
        L = torch.where(ok[..., None, None], L, Lnew)
        ok = ok | _diag_ok(Lnew)
        if bool(ok.all()):
            break
    return L, jitter


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b with A = L L^T."""
    squeeze = b.ndim == L.ndim - 1
    B = b[..., None] if squeeze else b
    y = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if squeeze else x


def solve_psd(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    L, _ = safe_cholesky(A, initial_jitter=jitter)
    return cho_solve(L, b)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|A| from its factor, clamped like the reference clamps the
    determinant (include/Likelihood.h:180-188), in log space."""
    ld = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return torch.clamp(ld, -_LDBL_LOG_MAX, _LDBL_LOG_MAX)
