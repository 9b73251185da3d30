"""Recursive blocked Cholesky with a lower-triangle trailing update.

Mirrors gpr_tpu/ops/blocked.py:30-47 (leaf and split points) and 174-281
(``_chol_rec``, ``cholesky_blocked_blocks``, ``assemble_blocks``).  Each
level splits the matrix at :func:`_round_split` (half of n rounded up to a
multiple of 128):

    [[A11, .  ],      L11 = chol(A11)                  (recursion)
     [A21, A22]]  ->  L21 = A21 L11^-T                 (triangular solve)
                      L22 = chol(A22 - L21 L21^T)      (K5, then recursion)

down to leaves of at most ``LEAF`` = 1024 rows, the JAX package's leaf for
its f32-grade tier (blocked.py:30-41), factored by ``torch.linalg.cholesky_ex``
as JAX uses ``lax.linalg.cholesky``.  The solve is ``torch.linalg
.solve_triangular`` on the block, as JAX computes it outside Pallas.  The
trailing update is :func:`ops.syrk.syrk_update` (K5) for float32 (the
kernel on a CUDA tensor, its plain version on a CPU tensor) and a
``torch.matmul`` for float64, as JAX's kernel is f32-only and the JAX
package uses ``jnp.matmul`` there.

Contracts (potrf 'L'): only the lower triangle of A is read (the leaves
mirror their lower triangle, every other read lies on or below the
diagonal), a failed pivot NaN-fills its leaf and so reaches L[-1, -1], and
the strict upper of the returned factor is exactly 0.

Where JAX builds a tree of blocks and assembles it, the port factors into
one n x n buffer in place: the leaves, L21 and the Schur complements are
written over the copy of A, so K5 updates A22 where it lies.  Its strict
upper still holds A's upper triangle and K5's undefined tiles until the
last step zeroes it.
"""

from __future__ import annotations

import torch

from .syrk import syrk_update

LEAF = 1024


def _round_split(n: int, align: int = 128) -> int:
    """Split point: half of n rounded up to the alignment (blocked.py:44-47)."""
    half = (n + 1) // 2
    return min(((half + align - 1) // align) * align, n - 1) if n > align else n // 2


def _leaf_cholesky(S: torch.Tensor) -> torch.Tensor:
    low = torch.tril(S)
    L, info = torch.linalg.cholesky_ex(low + torch.tril(low, -1).mT)
    # NaN where the factorization failed, as lax.linalg.cholesky returns it
    return torch.where(info != 0, torch.nan, L)


def _chol_rec(W: torch.Tensor, leaf: int) -> None:
    """Factor the (s, s) view W of the buffer in place (lower triangle)."""
    s = W.shape[0]
    if s <= leaf:
        W.copy_(_leaf_cholesky(W))
        return
    m = _round_split(s)
    _chol_rec(W[:m, :m], leaf)
    # L21 L11^T = A21
    W[m:, :m] = torch.linalg.solve_triangular(W[:m, :m].mT, W[m:, :m], upper=True, left=False)
    A22, L21 = W[m:, m:], W[m:, :m]
    if W.dtype == torch.float32:
        syrk_update(A22, L21, out=A22)
    else:
        A22.sub_(torch.matmul(L21, L21.mT))
    _chol_rec(A22, leaf)


def cholesky_blocked(A: torch.Tensor, *, leaf: int = LEAF) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A`` (n, n) by the recursion above;
    reads only the lower triangle of A and leaves A unchanged."""
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] == 0:
        raise ValueError(f"cholesky_blocked: shape {tuple(A.shape)} must be (n, n)")
    W = A.clone(memory_format=torch.contiguous_format)
    _chol_rec(W, leaf)
    return W.tril_()
