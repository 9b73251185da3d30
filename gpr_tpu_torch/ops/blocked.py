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
upper still holds A's upper triangle (on the CPU, the plain version's
full A22 - L21 L21^T) until the last step zeroes it.

With leaf inverses on (``leaf_inverse=True``, or ``GPR_CHOL_LEAF_INV=1`` read
at call time as blocked.py:309-313 reads it), every leaf that
:func:`ops.leaf.leaf_usable` admits (n % 256 == 0, n <= 1024; float32 on the
card, any dtype on the CPU) is factored in place by ``leaf_cholesky_wi``
(K13 on the card, its plain version on the CPU; blocked.py:208-223), and its
W = L^-1 is kept by the leaf's offset.  The column solves L21 = A21 L11^-T
then recurse as JAX's ``_solve_rt`` does (blocked.py:115-143): at a leaf with
W the solve is one ``torch.matmul`` B W^T, a plain product that JAX also
computes outside Pallas; at a leaf without W (a float64 leaf on the card, an
unaligned leaf) a triangular solve.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from .leaf import leaf_cholesky_wi, leaf_usable
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


def _leaf_inverse_default() -> bool:
    """``GPR_CHOL_LEAF_INV``, read at call time (blocked.py:309-313)."""
    return os.environ.get("GPR_CHOL_LEAF_INV", "0") not in ("0", "")


def _solve_rt(L: torch.Tensor, B: torch.Tensor, leaf: int, i0: int,
              invs: Dict[int, torch.Tensor]) -> None:
    """B <- X with X L^T = B, in place, for the lower triangle of L (s, s)
    at offset i0 of the factorization (blocked.py:115-143)."""
    s = L.shape[0]
    if s <= leaf:
        W = invs.get(i0)
        if W is not None:
            B.copy_(torch.matmul(B, W.mT))
        else:
            B.copy_(torch.linalg.solve_triangular(L.mT, B, upper=True, left=False))
        return
    m = _round_split(s)
    _solve_rt(L[:m, :m], B[:, :m], leaf, i0, invs)
    B[:, m:] -= torch.matmul(B[:, :m], L[m:, :m].mT)
    _solve_rt(L[m:, m:], B[:, m:], leaf, i0 + m, invs)


def _chol_rec(W: torch.Tensor, leaf: int, i0: int,
              invs: Optional[Dict[int, torch.Tensor]]) -> None:
    """Factor the (s, s) view W of the buffer, at offset i0, in place (lower
    triangle); with ``invs``, keep each kernel leaf's inverse by its offset."""
    s = W.shape[0]
    if s <= leaf:
        if invs is not None and leaf_usable(s, W.dtype, W.device):
            _, invs[i0] = leaf_cholesky_wi(W, out=W)
        else:
            W.copy_(_leaf_cholesky(W))
        return
    m = _round_split(s)
    _chol_rec(W[:m, :m], leaf, i0, invs)
    # L21 L11^T = A21
    if invs is None:
        W[m:, :m] = torch.linalg.solve_triangular(W[:m, :m].mT, W[m:, :m], upper=True, left=False)
    else:
        _solve_rt(W[:m, :m], W[m:, :m], leaf, i0, invs)
    A22, L21 = W[m:, m:], W[m:, :m]
    if W.dtype == torch.float32:
        syrk_update(A22, L21, out=A22)
    else:
        A22.sub_(torch.matmul(L21, L21.mT))
    _chol_rec(A22, leaf, i0 + m, invs)


def cholesky_blocked(A: torch.Tensor, *, leaf: int = LEAF,
                     leaf_inverse: Optional[bool] = None) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A`` (n, n) by the recursion above;
    reads only the lower triangle of A and leaves A unchanged.
    ``leaf_inverse`` None reads ``GPR_CHOL_LEAF_INV`` now."""
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] == 0:
        raise ValueError(f"cholesky_blocked: shape {tuple(A.shape)} must be (n, n)")
    if leaf_inverse is None:
        leaf_inverse = _leaf_inverse_default()
    W = A.clone(memory_format=torch.contiguous_format)
    _chol_rec(W, leaf, 0, {} if leaf_inverse else None)
    return W.tril_()
