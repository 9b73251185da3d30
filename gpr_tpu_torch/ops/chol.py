"""Single-tile Cholesky: K19 tile_chol, K20 tile_chol_strips and their leaf
dispatcher.

Mirrors gpr_tpu/ops/pallas_chol.py: ``cholesky_pallas`` (59; kernel
``_chol_kernel``, 29) is :func:`cholesky_tile`, ``cholesky_pallas_v2`` (133;
``_chol_strip_kernel``, 83) is :func:`cholesky_tile_v2` and the
backend-dispatching ``leaf_cholesky`` (72-76) is :func:`leaf_cholesky`.  That
dispatcher is a different function from the whole-leaf kernel K12 of the same
name in ops/leaf.py (pallas_leaf.py:85), as the JAX package has the same two
names.  Nothing else in the JAX package calls these kernels.

Both kernels return L = U^T, U the Cholesky factor of one (n, n) SPD tile
computed from its upper triangle; the plain versions follow the TPU kernels
step for step, U's rows by n rank-1 updates (K19) or by strips of ``sw``
rows, each factored in place and followed by one rank-sw trailing update
(K20).  The wrappers launch the hand-written CUDA kernel (``csrc/chol.cu``:
the tile held in one 8-CTA thread-block cluster's shared memory, factored by
32-wide diagonal blocks, each on one warp; K20 takes its strips inside each
diagonal block) for a CUDA float32 tile with n <= 512 (K20: sw in {8, 16};
the kernel's limits, which raise ``ValueError``), raise for another CUDA
dtype or a refused launch, and run the plain torch versions
(``*_reference``) for a CPU tensor of any float dtype and any n, as JAX runs
its kernels in interpret mode.  A tile that is not contiguous is copied
first.

Contracts (kept from the TPU kernels):
  * K19 reads only the upper triangle of A, so NaN below the diagonal leaves
    L unchanged.  K20 here reads only the upper triangle too; JAX's
    ``_chol_strip_kernel`` also reads the strict lower triangle inside each
    sw x sw diagonal block (its in-strip coefficients, pallas_chol.py:107-113),
    so the two agree on symmetric input only (ROADMAP section 3, "Settled");
  * the strict upper triangle of L is exactly 0;
  * a non-positive pivot at j leaves rows before j finite and every row from
    j on non-finite, with L[-1, -1] NaN (no clamp).  The scale is
    1 / sqrt(pivot) in both kernels (JAX's K19 uses rsqrt).
"""

from __future__ import annotations

import torch

from . import _cuda

MAX_N = 512  # csrc/chol.cu: kCholMaxN, two 32-column blocks per CTA of an 8-CTA cluster; the dispatcher's cap
STRIP_WIDTHS = (8, 16)  # K20's strip widths (csrc/chol.cu: gpr_tile_chol_strips)
_SLOT = 32 * (MAX_N - 32)  # csrc/chol.cu: kCholSlot, one published panel's floats


def _lower_from_upper(U: torch.Tensor) -> torch.Tensor:
    """L = U^T with U's strict lower residue masked to exact zeros."""
    n = U.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool, device=U.device).triu()
    return torch.where(upper, U, torch.zeros((), dtype=U.dtype, device=U.device)).mT.contiguous()


def cholesky_tile_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K19, step for step as ``_chol_kernel``: for each
    row j of U, u = row j (from column j on) / sqrt(pivot), then rows > j
    lose outer(u, u) right of column j (JAX updates whole rows; the part left
    of the diagonal is residue that both mask at the end).  Only A's upper
    triangle reaches the result."""
    n = _check("cholesky_tile", A)
    U = A.clone()
    col = torch.arange(n, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for j in range(n):
        inv = 1.0 / torch.sqrt(U[j, j])
        u = torch.where(col >= j, U[j] * inv, zero)
        U[j] = u
        U[j + 1:, j + 1:] -= torch.outer(u[j + 1:], u[j + 1:])
    return _lower_from_upper(U)


def cholesky_tile_v2_reference(A: torch.Tensor, *, sw: int = 8) -> torch.Tensor:
    """Plain torch version of K20, step for step as ``_chol_strip_kernel``:
    each strip of sw rows is factored by sw rank-1 steps confined to it, then
    the rows below lose one rank-sw product.  The in-strip coefficients come
    from the pivot row (the upper triangle), where JAX reads the strip's rows
    below the pivot."""
    n = _check("cholesky_tile_v2", A, sw=sw)
    U = A.clone()
    col = torch.arange(n, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for j0 in range(0, n, sw):
        S = U[j0:j0 + sw].clone()
        for r in range(sw):
            j = j0 + r
            inv = 1.0 / torch.sqrt(S[r, j])
            u = torch.where(col >= j, S[r] * inv, zero)
            S[r] = u
            S[r + 1:] -= u[j + 1:j0 + sw, None] * u
        U[j0:j0 + sw] = S
        e = j0 + sw
        U[e:, e:] -= S[:, e:].mT @ S[:, e:]
    return _lower_from_upper(U)


def cholesky_tile(A: torch.Tensor) -> torch.Tensor:
    """K19: the lower Cholesky factor of one small SPD tile (n <= 512 on the
    card), computed from its upper triangle by n rank-1 updates; a new (n, n)
    tensor."""
    n = _check("cholesky_tile", A)
    if A.device.type == "cpu":
        return cholesky_tile_reference(A)
    A = _kernel_input("cholesky_tile", A, n)
    L, W = torch.empty_like(A), _workspace(A, n)
    _cuda.TILE_CHOL.launch(A.device, A.data_ptr(), L.data_ptr(), W.data_ptr(), n)
    return L


def cholesky_tile_v2(A: torch.Tensor, *, sw: int = 8) -> torch.Tensor:
    """K20: :func:`cholesky_tile` by strips of ``sw`` rows, each followed by
    one rank-sw trailing update.  ``ValueError`` unless sw divides n, as
    ``cholesky_pallas_v2``; on the card sw is 8 or 16."""
    n = _check("cholesky_tile_v2", A, sw=sw)
    if A.device.type == "cpu":
        return cholesky_tile_v2_reference(A, sw=sw)
    A = _kernel_input("cholesky_tile_v2", A, n)
    if sw not in STRIP_WIDTHS:
        raise ValueError(f"cholesky_tile_v2: the kernel takes strip widths {STRIP_WIDTHS}, got {sw}")
    L, W = torch.empty_like(A), _workspace(A, n)
    _cuda.TILE_CHOL_STRIPS.launch(A.device, A.data_ptr(), L.data_ptr(), W.data_ptr(), n, sw)
    return L


def leaf_cholesky(A: torch.Tensor) -> torch.Tensor:
    """The backend-dispatching leaf factorization (pallas_chol.py:72-76).

    A CUDA float32 (n, n) tile with n <= 512 goes to K19, as JAX sends n <=
    512 to ``cholesky_pallas`` on its accelerator; the gate names float32
    because K19 takes nothing else.  Everything else (the CPU, another dtype,
    larger n, a batch) is ``torch.linalg.cholesky_ex`` of (A + A^T) / 2, as
    ``jnp.linalg.cholesky`` symmetrizes its input by default; where that
    factorization fails, the lower triangle is NaN, as JAX returns it."""
    if (A.device.type == "cuda" and A.dtype == torch.float32 and A.ndim == 2
            and A.shape[0] == A.shape[1] and 1 <= A.shape[0] <= MAX_N):
        return cholesky_tile(A)
    L, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
    failed = (info != 0)[..., None, None]
    return torch.where(failed, torch.full_like(L, torch.nan), L).tril()


def _kernel_input(name: str, A: torch.Tensor, n: int) -> torch.Tensor:
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    if A.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32, got {A.dtype}")
    if n > MAX_N:
        raise ValueError(f"{name}: the kernel takes n <= {MAX_N} (the tile held in one thread-block "
                         f"cluster's shared memory), got {n}")
    return A.contiguous()


def _workspace(A: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's panel workspace: a slot for every diagonal step's panel
    but the last (each published once, then read by every CTA from L2)."""
    return torch.empty(max((n + 31) // 32 - 1, 1) * _SLOT, dtype=A.dtype, device=A.device)


def _check(name: str, A: torch.Tensor, sw: int | None = None) -> int:
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] == 0:
        raise ValueError(f"{name}: A must be a non-empty square tile, got {tuple(A.shape)}")
    n = A.shape[0]
    if sw is not None and (sw < 1 or n % sw):
        raise ValueError(f"{name}: strip width {sw} must divide n={n}")
    return n
