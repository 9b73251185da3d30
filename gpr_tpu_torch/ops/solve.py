"""The narrow Cholesky solve: (L L^T) X = B for a skinny right-hand side.

Mirrors gpr_tpu/ops/pallas_solve.py:161-347 (``_diag_block_inverses``,
``_diag_block_inverses_pallas``, ``_diag_inv_mode``, ``solve_narrow_usable``,
``cho_solve_narrow`` and its custom VJP).  Three steps per solve:

1. W_i = inv(L_ii) of the (bs, bs) diagonal tiles (:func:`diag_block_inverses`),
   by the scheme ``GPR_SOLVE_DIAGINV`` names at call time: ``xla`` (default)
   one batched ``torch.linalg.solve_triangular`` of the stacked tiles against
   I, where JAX calls its batched triangular solve; ``pallas`` kernel K11
   diag_tri_inv (:func:`diag_tri_inv`), where JAX runs its Pallas kernel: on
   the card a blocked inverse, 32-wide diagonal blocks, then pairs of blocks
   joined level by level (h = 32 .. bs / 2) by the identity JAX uses for
   bs = 1024 below.
   bs = 1024 joins two 512 inverses with two batched products, as JAX does.
2. the forward substitution  y_i = W_ii (b_i - sum_{j<i} L_ij y_j),
3. the backward substitution x_i = W_ii^T (y_i - sum_{j>i} L_ji^T x_j),
   each a sweep of kernel K10 narrow_subst (:func:`subst_pass`), one counted
   launch per sweep.

Only the lower triangle of L is read.  On a CUDA tensor each step launches its
kernel (csrc/solve.cu); on a CPU tensor it runs its plain torch version
(``subst_pass_reference``, ``diag_tri_inv_reference``), as JAX runs its
kernels in interpret mode on the CPU.  The public layout is (n, q); the TPU's
transposed (nb, q, bs) layout is its sublane layout, not a contract.

``cho_solve_narrow`` is differentiable: its backward is JAX's custom VJP
(pallas_solve.py:298-314), one more narrow solve W = (L L^T)^-1 Xbar and
L_bar = -tril(W (X^T L) + X (W^T L)), B_bar = W.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from . import _cuda

CHUNK = 128  # csrc/solve.cu: kSubstChunk, the first level of K10's sums
INV_MAX_TILE = 512  # csrc/solve.cu: kInvMaxTile


def _diag_inv_mode() -> str:
    """``GPR_SOLVE_DIAGINV``, read at call time: 'xla' (default) or 'pallas'."""
    return os.environ.get("GPR_SOLVE_DIAGINV", "xla")


def solve_narrow_usable(n: int, q: int, dtype: torch.dtype, device, bs: int = 512) -> bool:
    """The narrow solve applies to float32, bs-aligned n with at least two
    blocks, and q <= 128 (pallas_solve.py:239-251).  JAX asks for a TPU
    backend or interpret mode; here a CUDA tensor runs the kernels and a CPU
    tensor their plain versions, so both devices are admitted."""
    return (dtype == torch.float32 and n % bs == 0 and n // bs >= 2 and q <= 128
            and torch.device(device).type in ("cpu", "cuda"))


def _diag_tiles(L: torch.Tensor, bs: int) -> torch.Tensor:
    nb = L.shape[0] // bs
    return torch.stack([L[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] for i in range(nb)])


def diag_tri_inv_reference(L: torch.Tensor, bs: int) -> torch.Tensor:
    """Plain torch version of K11: every tile's inverse by forward
    substitution, one row of all the tiles' inverses per step."""
    D = torch.tril(_diag_tiles(L, bs))
    W = torch.zeros_like(D)
    eye = torch.eye(bs, dtype=L.dtype, device=L.device)
    for i in range(bs):
        acc = torch.matmul(D[:, i:i + 1, :i], W[:, :i, :]) if i else 0.0
        W[:, i:i + 1, :] = (eye[i] - acc) / D[:, i:i + 1, i:i + 1]
    return W


def diag_tri_inv(L: torch.Tensor, bs: int) -> torch.Tensor:
    """K11: W (n / bs, bs, bs), W_i = inv(tril(L_ii)), bs <= 512, exact-zero
    strict upper.  A CUDA tensor launches the kernel, a CPU tensor runs
    :func:`diag_tri_inv_reference`."""
    n = _check_square(L, "diag_tri_inv")
    if bs < 16 or bs % 16 or bs > INV_MAX_TILE or n % bs:
        raise ValueError(f"diag_tri_inv: bs={bs} must be a multiple of 16 <= {INV_MAX_TILE} "
                         f"dividing n={n}")
    if L.device.type == "cpu":
        return diag_tri_inv_reference(L, bs)
    L = L.contiguous()
    W = torch.empty((n // bs, bs, bs), dtype=L.dtype, device=L.device)
    _cuda.DIAG_TRI_INV.launch(L.device, L.data_ptr(), n, W.data_ptr(), n // bs, bs)
    return W


def diag_block_inverses(L: torch.Tensor, bs: int, scheme: Optional[str] = None) -> torch.Tensor:
    """W (n / bs, bs, bs), W_i = inv(tril(L_ii)), by ``scheme`` ('xla' or
    'pallas'; None reads ``GPR_SOLVE_DIAGINV``)."""
    scheme = _diag_inv_mode() if scheme is None else scheme
    if scheme == "xla":
        eye = torch.eye(bs, dtype=L.dtype, device=L.device)
        return torch.linalg.solve_triangular(torch.tril(_diag_tiles(L, bs)), eye, upper=False)
    if scheme != "pallas":
        raise ValueError(f"GPR_SOLVE_DIAGINV={scheme!r}: expected 'xla' or 'pallas'")
    if bs <= INV_MAX_TILE:
        return diag_tri_inv(L, bs)
    if bs != 1024:
        raise ValueError(f"diag_block_inverses: unsupported bs={bs}")
    # inv([[A, 0], [C, D]]) = [[inv(A), 0], [-inv(D) C inv(A), inv(D)]]
    # (pallas_solve.py:213-227)
    h = 512
    W = diag_tri_inv(L, h)
    W1, W2 = W[0::2], W[1::2]
    nb = L.shape[0] // bs
    C = torch.stack([L[i * bs + h:(i + 1) * bs, i * bs:i * bs + h] for i in range(nb)])
    off = -torch.matmul(torch.matmul(W2, C), W1)
    top = torch.cat([W1, torch.zeros_like(W1)], dim=2)
    return torch.cat([top, torch.cat([off, W2], dim=2)], dim=1)


def subst_pass_reference(L: torch.Tensor, W: torch.Tensor, B: torch.Tensor,
                         forward: bool) -> torch.Tensor:
    """Plain torch version of K10: one whole sweep, block row by block row."""
    nb, bs, _ = W.shape
    out = torch.empty_like(B)
    rows = range(nb) if forward else range(nb - 1, -1, -1)
    for i in rows:
        s, e = i * bs, (i + 1) * bs
        rhs = B[s:e]
        if forward and i:
            rhs = rhs - L[s:e, :s] @ out[:s]
        elif not forward and e < L.shape[0]:
            rhs = rhs - L[e:, s:e].T @ out[e:]
        out[s:e] = (W[i] if forward else W[i].T) @ rhs
    return out


def subst_pass(L: torch.Tensor, W: torch.Tensor, B: torch.Tensor, forward: bool) -> torch.Tensor:
    """K10: one sweep of the block substitution with the diagonal-tile
    inverses W (nb, bs, bs) over B (n, q): forward gives y = L^-1 B, backward
    x = L^-T B.  One counted launch per sweep, as JAX's one ``pallas_call``:
    on the card a persistent kernel whose CTAs take the sweep's work items
    (128-column partial products, their sums, then each block row's W step
    by 128-column chunks) in order from a ticket counter and wait on per-row
    flags in device memory, which this wrapper allocates zeroed with the
    kernel's scratch.  A CPU tensor runs :func:`subst_pass_reference`."""
    n = _check_square(L, "subst_pass")
    nb, bs, _ = W.shape
    if W.shape != (nb, bs, bs) or nb * bs != n or B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"subst_pass: bad shapes L {tuple(L.shape)} W {tuple(W.shape)} "
                         f"B {tuple(B.shape)}")
    if L.device.type == "cpu":
        return subst_pass_reference(L, W, B, forward)
    if bs % CHUNK or bs > 8 * CHUNK:
        raise ValueError(f"subst_pass: bs={bs} must be a multiple of {CHUNK} up to {8 * CHUNK} on the card")
    q = B.shape[1]
    L, W, B = L.contiguous(), W.contiguous(), B.contiguous()
    out = torch.empty_like(B)
    # two sets of partial slots (alternate block rows), then the diagonal
    # step's chunk products (bs / 128, n, q); r_i of every block row; the
    # flags per (block row, 64-row group, column group of 8 or 16): finished
    # older and newest partials, the older ones' sum, r, finished diagonal
    # chunks, rows solved; then the ticket
    chunks = bs // CHUNK
    P = torch.empty((2 * max(nb - 1, 1) * chunks * bs + chunks * n) * q, dtype=B.dtype, device=B.device)
    R = torch.empty_like(B)
    zq = -(-q // (8 if q <= 8 else 16))
    flags = torch.zeros(6 * nb * (bs // 64) * zq + 1, dtype=torch.int32, device=B.device)
    _cuda.NARROW_SUBST.launch(L.device, L.data_ptr(), W.data_ptr(), B.data_ptr(), out.data_ptr(),
                              P.data_ptr(), R.data_ptr(), flags.data_ptr(), n, q, bs, int(forward))
    return out


def _check_square(L, name) -> int:
    if L.ndim != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"{name}: L must be (n, n), got {tuple(L.shape)}")
    if L.dtype != torch.float32:
        raise ValueError(f"{name}: L must be float32, got {L.dtype}")
    if L.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {L.device}")
    return L.shape[0]


def _narrow_impl(L, B, bs, diag_inv):
    n, q = B.shape
    if n % bs or L.shape != (n, n):
        raise ValueError(f"cho_solve_narrow: bad shapes {tuple(L.shape)} {tuple(B.shape)}")
    # the kernels read L row-major: a column-major factor (torch.linalg.cholesky's)
    # is copied once here, not once in each of the three kernels' wrappers
    L = L.contiguous()
    W = diag_block_inverses(L, bs, diag_inv)
    return subst_pass(L, W, subst_pass(L, W, B, True), False)


class _ChoSolveNarrow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, B, bs, diag_inv):
        X = _narrow_impl(L, B, bs, diag_inv)
        ctx.save_for_backward(L, X)
        ctx.bs, ctx.diag_inv = bs, diag_inv
        return X

    @staticmethod
    def backward(ctx, X_bar):
        # X = (L L^T)^-1 B: A_bar = -W X^T, L_bar = (A_bar + A_bar^T) L in
        # O(n^2 q) as W (X^T L) + X (W^T L); only tril(L) is read, so the
        # cotangent lives in the lower triangle (pallas_solve.py:298-314)
        L, X = ctx.saved_tensors
        W = _narrow_impl(L, X_bar.contiguous(), ctx.bs, ctx.diag_inv)
        L_bar = -torch.tril(W @ (X.T @ L) + X @ (W.T @ L))
        return L_bar, W, None, None


def cho_solve_narrow(L: torch.Tensor, B: torch.Tensor, bs: int = 512,
                     diag_inv: Optional[str] = None) -> torch.Tensor:
    """Solve (L L^T) X = B for a skinny B, (n, q) or (n,), with L (n, n)
    lower-triangular float32, n % bs == 0; reads only tril(L).
    ``diag_inv`` 'xla' or 'pallas' (None reads ``GPR_SOLVE_DIAGINV`` now).
    Differentiable in L and B."""
    diag_inv = _diag_inv_mode() if diag_inv is None else diag_inv
    if B.ndim == 1:
        return _ChoSolveNarrow.apply(L, B[:, None], int(bs), diag_inv)[:, 0]
    return _ChoSolveNarrow.apply(L, B, int(bs), diag_inv)
