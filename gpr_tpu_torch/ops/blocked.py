"""Recursive blocked Cholesky with a lower-triangle trailing update, and
the blocked triangular solves around it.

Mirrors gpr_tpu/ops/blocked.py:30-47 (leaf and split points), 50-86
(``solve_triangular_blocked``), 146-281 (``_chol_rec``, the block tree:
``cholesky_blocked_blocks``, ``assemble_blocks*``, ``last_leaf``), 337-397
(``cholesky_blocked``, ``_solve_r``, ``cho_solve_blocked``) and 400-540 (the
study schedules ``cholesky_rightlooking``, ``solve_triangular_blocked_v2``,
``cholesky_blocked_v2``).  Each
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

The block tree of :func:`cholesky_blocked_blocks` is made of views of that
one factored buffer: a leaf is the (s, s) view of a recursion leaf, a node
``(b11, L21, b22)``, as JAX's tree is made of arrays (blocked.py:146-205).

The solves (``solve_triangular_blocked``, ``_solve_r``, ``cho_solve_blocked``)
recurse at the same split points, leaves by ``torch.linalg
.solve_triangular`` and updates by ``torch.matmul``, as JAX computes both
outside Pallas.  They build their result by concatenation, not in place, so
autograd can differentiate them in L and B.  JAX's ``cho_solve_blocked``
runs both passes right-side to spare the TPU a transpose of L; in torch a
transposed operand costs a GEMM nothing, so its forward pass is the
left-side ``solve_triangular_blocked`` (the same products as ``_solve_rt``,
transposed) and its backward pass ``_solve_r``.  ``lower=False`` solves the
flipped problem as JAX does, splitting at the flipped split point without
the copy a flipped tensor costs in torch.  JAX's leaf size and
``GPR_CHOL_LEAF`` / ``GPR_CHOL_ASSEMBLE`` are TPU tuning: the leaf here is
``LEAF``, and ``assemble_blocks`` writes each block once into a zero buffer.
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


# ---------------------------------------------------------------------------
# the block tree (blocked.py:146-205, 264-281)
# ---------------------------------------------------------------------------

def _tree(W: torch.Tensor, leaf: int):
    s = W.shape[0]
    if s <= leaf:
        return W
    m = _round_split(s)
    return (_tree(W[:m, :m], leaf), W[m:, :m], _tree(W[m:, m:], leaf))


def cholesky_blocked_blocks(A: torch.Tensor, *, leaf: int = LEAF,
                            leaf_inverse: Optional[bool] = None):
    """:func:`cholesky_blocked` as its block tree (blocked.py:264-281): a
    leaf is the factor of a recursion leaf, a node ``(b11, L21, b22)``, every
    block a view of one factored buffer whose strict upper is 0."""
    return _tree(cholesky_blocked(A, leaf=leaf, leaf_inverse=leaf_inverse), leaf)


def _walk_blocks(b, i0: int, j0: int, out: list) -> int:
    """Flatten a block tree into (row, col, block) triples (blocked.py:146-155)."""
    if not isinstance(b, tuple):
        out.append((i0, j0, b))
        return b.shape[0]
    b11, L21, b22 = b
    m = _walk_blocks(b11, i0, j0, out)
    out.append((i0 + m, j0, L21))
    return m + _walk_blocks(b22, i0 + m, j0 + m, out)


def assemble_blocks_dus(b) -> torch.Tensor:
    """The factor of a block tree, each block written once into a zero
    buffer (blocked.py:158-172)."""
    if not isinstance(b, tuple):
        return b
    blocks: list = []
    n = _walk_blocks(b, 0, 0, blocks)
    L = blocks[0][2]
    out = torch.zeros((n, n), dtype=L.dtype, device=L.device)
    for i0, j0, blk in blocks:
        out[i0:i0 + blk.shape[0], j0:j0 + blk.shape[1]] = blk
    return out


def assemble_blocks_concat(b) -> torch.Tensor:
    """The factor of a block tree by concatenation (blocked.py:186-197)."""
    if not isinstance(b, tuple):
        return b
    b11, L21, b22 = b
    L11, L22 = assemble_blocks_concat(b11), assemble_blocks_concat(b22)
    top = torch.cat([L11, L11.new_zeros((L11.shape[0], L22.shape[0]))], 1)
    return torch.cat([top, torch.cat([L21, L22], 1)])


def assemble_blocks(b) -> torch.Tensor:
    """The lower-triangular factor of a block tree (blocked.py:175-183)."""
    return assemble_blocks_dus(b)


def last_leaf(b) -> torch.Tensor:
    """The bottom-right leaf of a block tree: a failed pivot anywhere makes
    its last diagonal entry NaN (blocked.py:200-205)."""
    while isinstance(b, tuple):
        b = b[2]
    return b


# ---------------------------------------------------------------------------
# the blocked triangular solves (blocked.py:50-86, 363-397)
# ---------------------------------------------------------------------------

def _solve_upper(U: torch.Tensor, B: torch.Tensor, leaf: int) -> torch.Tensor:
    """X with U X = B, U upper: the recursion of JAX's flipped problem,
    whose split at ``_round_split(s)`` from the far end is ``s - m`` here."""
    s = U.shape[0]
    if s <= leaf:
        return torch.linalg.solve_triangular(U, B, upper=True)
    m = s - _round_split(s)
    X2 = _solve_upper(U[m:, m:], B[m:], leaf)
    X1 = _solve_upper(U[:m, :m], B[:m] - torch.matmul(U[:m, m:], X2), leaf)
    return torch.cat([X1, X2])


def solve_triangular_blocked(L: torch.Tensor, B: torch.Tensor, *, lower: bool = True,
                             leaf: int = LEAF) -> torch.Tensor:
    """X with L X = B, L (n, n) lower (``lower=False``: upper), B (n,) or
    (n, q), recursively blocked (blocked.py:50-86):

        X1 = L11^-1 B1,  X2 = L22^-1 (B2 - L21 X1)."""
    if B.ndim == 1:
        return solve_triangular_blocked(L, B[:, None], lower=lower, leaf=leaf)[:, 0]
    if not lower:
        return _solve_upper(L, B, leaf)
    s = L.shape[0]
    if s <= leaf:
        return torch.linalg.solve_triangular(L, B, upper=False)
    m = _round_split(s)
    X1 = solve_triangular_blocked(L[:m, :m], B[:m], leaf=leaf)
    X2 = solve_triangular_blocked(L[m:, m:], B[m:] - torch.matmul(L[m:, :m], X1), leaf=leaf)
    return torch.cat([X1, X2])


def _solve_r(L: torch.Tensor, B: torch.Tensor, leaf: int) -> torch.Tensor:
    """X with X L = B, B (r, n), L lower (blocked.py:363-380)."""
    s = L.shape[0]
    if s <= leaf:
        return torch.linalg.solve_triangular(L, B, upper=False, left=False)
    m = _round_split(s)
    X2 = _solve_r(L[m:, m:], B[:, m:], leaf)
    X1 = _solve_r(L[:m, :m], B[:, :m] - torch.matmul(X2, L[m:, :m]), leaf)
    return torch.cat([X1, X2], 1)


def cho_solve_blocked(L: torch.Tensor, B: torch.Tensor, *, leaf: int = LEAF) -> torch.Tensor:
    """X with L L^T X = B, B (n,) or (n, q) (blocked.py:383-397): Y = L^-1 B
    by :func:`solve_triangular_blocked`, then X^T = Y^T L^-1 by
    :func:`_solve_r`."""
    if B.ndim == 1:
        return cho_solve_blocked(L, B[:, None], leaf=leaf)[:, 0]
    Y = solve_triangular_blocked(L, B, leaf=leaf)
    return _solve_r(L, Y.mT, leaf).mT


# ---------------------------------------------------------------------------
# study schedules (blocked.py:400-540), as JAX keeps them for comparison
# ---------------------------------------------------------------------------

def cholesky_rightlooking(A: torch.Tensor, *, panel: int = 512, leaf: int = 256) -> torch.Tensor:
    """Right-looking panel Cholesky carrying only the shrinking trailing
    Schur complement, symmetrized each panel (blocked.py:400-457); n padded
    to a multiple of ``panel`` by an identity block."""
    n = A.shape[0]
    if n <= panel:
        return cholesky_blocked(A, leaf=leaf)
    pad = (-n) % panel
    if pad:
        A = torch.block_diag(A, torch.eye(pad, dtype=A.dtype, device=A.device))
    S = A
    cols = []
    for k in range(A.shape[0] // panel):
        Lkk = cholesky_blocked(S[:panel, :panel], leaf=leaf)
        if S.shape[0] > panel:
            Pk = solve_triangular_blocked(Lkk, S[panel:, :panel].mT, leaf=leaf).mT
            S = S[panel:, panel:] - torch.matmul(Pk, Pk.mT)
            S = 0.5 * (S + S.mT)
        else:
            Pk = A.new_zeros((0, panel))
        cols.append(torch.cat([A.new_zeros((k * panel, panel)), Lkk, Pk]))
    return torch.cat(cols, 1)[:n, :n]


def _solve_lower_into(L, B_cur, out, i0: int, leaf: int) -> None:
    """The lower solve written into ``out`` at offset i0 (blocked.py:464-479)."""
    s = B_cur.shape[0]
    if s <= leaf:
        out[i0:i0 + s] = torch.linalg.solve_triangular(L[i0:i0 + s, i0:i0 + s], B_cur, upper=False)
        return
    m = _round_split(s)
    _solve_lower_into(L, B_cur[:m], out, i0, leaf)
    rhs = B_cur[m:] - torch.matmul(L[i0 + m:i0 + s, i0:i0 + m], out[i0:i0 + m])
    _solve_lower_into(L, rhs, out, i0 + m, leaf)


def solve_triangular_blocked_v2(L: torch.Tensor, B: torch.Tensor, *, lower: bool = True,
                                leaf: int = 256) -> torch.Tensor:
    """The blocked solve written into one buffer instead of concatenated
    (blocked.py:482-493); ``lower=False`` on the flipped problem."""
    if not lower:
        return solve_triangular_blocked_v2(L.flip(0, 1), B.flip(0), lower=True, leaf=leaf).flip(0)
    out = torch.zeros_like(B)
    _solve_lower_into(L, B, out, 0, leaf)
    return out


def _chol_into(A_cur, out, i0: int, leaf: int) -> None:
    """Factor the Schur block ``A_cur`` (offset i0) into ``out``, reading
    its lower triangle (blocked.py:496-522)."""
    s = A_cur.shape[0]
    if s <= leaf:
        out[i0:i0 + s, i0:i0 + s] = _leaf_cholesky(A_cur)
        return
    m = _round_split(s)
    _chol_into(A_cur[:m, :m], out, i0, leaf)
    L11 = out[i0:i0 + m, i0:i0 + m]
    L21 = solve_triangular_blocked_v2(L11, A_cur[m:, :m].mT, leaf=leaf).mT
    out[i0 + m:i0 + s, i0:i0 + m] = L21
    _chol_into(A_cur[m:, m:] - torch.matmul(L21, L21.mT), out, i0 + m, leaf)


def cholesky_blocked_v2(A: torch.Tensor, *, leaf: int = 256) -> torch.Tensor:
    """The recursive Cholesky written into one preallocated buffer
    (blocked.py:525-540; JAX's ``gemm_dtype``, which only its benchmarks
    set, is left out).  At n <= leaf, the factor of (A + A^T) / 2, as
    ``jnp.linalg.cholesky`` symmetrizes its input."""
    if A.shape[0] <= leaf:
        return _leaf_cholesky(0.5 * (A + A.mT))
    out = torch.zeros_like(A)
    _chol_into(A, out, 0, leaf)
    return out
