"""Batched Cholesky of small SPD tiles: K7 crout_chol and K8 crout_chol_wi.

Mirrors gpr_tpu/ops/pallas_batched.py:47-303: the Crout sweep
``_crout_sweep`` (47-196), W-free (its step at 85-96) in ``_crout_l_kernel``
(205) / ``crout_chol`` (211), and with the inverse W = L^-1 (its step at
97-117) in ``_crout_wi_kernel`` (199) / ``crout_chol_wi`` (253).  The fleet
factorization (ops/batched.py) calls K7 once per panel step on the diagonal
blocks of all members; K8 serves the fleet solve without the diagonal-block
inverses and the ``crout`` diagonal scheme.  Each wrapper launches its
hand-written CUDA kernel (``csrc/crout.cu``) for a CUDA tensor and runs its
plain version for a CPU tensor.

Contracts (potrf 'L', as the TPU kernels'): only the lower triangle of each
tile is read; the strict uppers of L and W are exactly 0; a non-positive
pivot gives NaN through the arithmetic, with no clamp and no early exit, in
its tile only, so that tile's L[-1, -1] is NaN (non-finite in the plain
versions, as in JAX's).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

MAX_TILE = 128  # csrc/crout.cu: kCroutMaxTile


def crout_chol_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K7: the JAX package's W-free column sweep,
    one Python step per column of the (B, b, b) batch (pallas_batched.py:
    60-96).  A non-positive pivot makes 1 / max(piv, 0) infinite, which
    turns the tile's trailing matrix, and so its later columns, into NaN."""
    _check("crout_chol", A)
    b = A.shape[-1]
    rows = torch.arange(b, device=A.device)[:, None]
    cols = rows.mT
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    # mirror the lower triangle: the upper may hold anything
    S = torch.where(rows >= cols, A, zero) + torch.where(rows > cols, A, zero).mT
    L = torch.zeros_like(S)
    for j in range(b):
        colr = S[:, :, j:j + 1]                        # (B, b, 1)
        piv = torch.clamp(S[:, j:j + 1, j:j + 1], min=0.0)  # (B, 1, 1)
        colu = torch.where(rows > j, colr, zero)
        S = S - (colu * (1.0 / piv)) * colu.mT
        L[:, :, j:j + 1] = torch.where(rows >= j, colr * torch.rsqrt(piv), zero)
    return L


def crout_chol(A: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7: the lower Cholesky factor of every tile of ``A`` (B, b, b), b <=
    128, into ``out`` (a new tensor when None).  ``A`` and ``out`` are
    float32 views whose rows are contiguous (``stride(-1) == 1``), e.g. the
    diagonal blocks of a (B, n, n) buffer; ``out`` may be ``A`` itself.  A
    CUDA tensor launches the kernel; a CPU tensor runs
    :func:`crout_chol_reference`."""
    _check("crout_chol", A, out=out)
    if A.device.type == "cpu":
        L = crout_chol_reference(A)
        return L if out is None else out.copy_(L)
    B, b, _ = A.shape
    if A.dtype != torch.float32:
        raise ValueError(f"crout_chol: the kernel takes float32, got {A.dtype}")
    if b > MAX_TILE:
        raise ValueError(f"crout_chol: tile {b} exceeds the kernel's {MAX_TILE}")
    if out is None:
        out = torch.empty((B, b, b), dtype=torch.float32, device=A.device)
    _cuda.CROUT_CHOL.launch(A.device, A.data_ptr(), A.stride(0), A.stride(1), out.data_ptr(),
                            out.stride(0), out.stride(1), B, b)
    return out


def crout_chol_wi_reference(A: torch.Tensor):
    """Plain torch version of K8: the JAX package's with-W column sweep, one
    Python step per column of the (B, b, b) batch (pallas_batched.py:60-117):
    column j of L from rsqrt(max(pivot, 0)), the trailing rank-1 update, and
    row j of W by forward substitution against the rows of W before it.  A
    non-positive pivot makes rsqrt(0) infinite, which leaves the tile's later
    entries non-finite."""
    _check("crout_chol_wi", A)
    b = A.shape[-1]
    rows = torch.arange(b, device=A.device)[:, None]
    cols = rows.mT
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    S = torch.where(rows >= cols, A, zero) + torch.where(rows > cols, A, zero).mT
    L = torch.zeros_like(S)
    W = torch.zeros_like(S)
    for j in range(b):
        rd = torch.rsqrt(torch.clamp(S[:, j:j + 1, j:j + 1], min=0.0))  # (B, 1, 1)
        colj = torch.where(rows >= j, S[:, :, j:j + 1] * rd, zero)
        L[:, :, j:j + 1] = colj
        colu = torch.where(rows > j, colj, zero)
        S = S - colu * colu.mT
        # W[j, :j] = -(L[j, :j] W[:j, :j]) / L[j, j],  W[j, j] = 1 / L[j, j]
        lrow = torch.where(cols < j, L[:, j:j + 1, :], zero)
        W[:, j:j + 1, :] = torch.where(cols < j, -torch.matmul(lrow, W) * rd,
                                       torch.where(cols == j, rd, zero))
    return L, W


def crout_chol_wi(A: torch.Tensor, L_out: Optional[torch.Tensor] = None,
                  W_out: Optional[torch.Tensor] = None):
    """K8: (L, W = L^-1) of every tile of ``A`` (B, b, b), b <= 128, into
    ``L_out`` and ``W_out`` (new tensors when None).  The views take
    :func:`crout_chol`'s rule (float32, rows contiguous); ``L_out`` may be
    ``A`` itself, ``W_out`` may share no memory with ``A``.  A CUDA tensor
    launches the kernel; a CPU tensor runs :func:`crout_chol_wi_reference`."""
    _check("crout_chol_wi", A, L_out=L_out, W_out=W_out)
    if W_out is not None and any(t is not None and t.data_ptr() == W_out.data_ptr()
                                 for t in (A, L_out)):
        raise ValueError("crout_chol_wi: W_out must not be A or L_out")
    if A.device.type == "cpu":
        L, W = crout_chol_wi_reference(A)
        return (L if L_out is None else L_out.copy_(L)), (W if W_out is None else W_out.copy_(W))
    B, b, _ = A.shape
    if A.dtype != torch.float32:
        raise ValueError(f"crout_chol_wi: the kernel takes float32, got {A.dtype}")
    if b > MAX_TILE:
        raise ValueError(f"crout_chol_wi: tile {b} exceeds the kernel's {MAX_TILE}")
    L_out = torch.empty_like(A, memory_format=torch.contiguous_format) if L_out is None else L_out
    W_out = torch.empty_like(A, memory_format=torch.contiguous_format) if W_out is None else W_out
    _cuda.CROUT_CHOL_WI.launch(A.device, A.data_ptr(), A.stride(0), A.stride(1),
                               L_out.data_ptr(), L_out.stride(0), L_out.stride(1),
                               W_out.data_ptr(), W_out.stride(0), W_out.stride(1), B, b)
    return L_out, W_out


def _check(name, A, **outs):
    if A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[0] == 0 or A.shape[1] == 0:
        raise ValueError(f"{name}: shape {tuple(A.shape)} must be (B, b, b), B, b >= 1")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {A.device}")
    for label, t in [("A", A), *outs.items()]:
        if t is None:
            continue
        if t.shape != A.shape or t.dtype != A.dtype or t.device != A.device:
            raise ValueError(f"{name}: {label} must match A's shape, dtype and device")
        # rows contiguous: the kernel indexes t[i * stride(0) + r * stride(1) + c]
        if t.shape[2] > 1 and (t.stride(2) != 1 or t.stride(1) < t.shape[2]):
            raise ValueError(f"{name}: {label} must be a row-major view (strides {t.stride()})")
