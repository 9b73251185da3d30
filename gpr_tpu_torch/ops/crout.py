"""Batched Cholesky of small SPD tiles (kernel K7).

Mirrors gpr_tpu/ops/pallas_batched.py:47-249, the L-only part: the W-free
``_crout_sweep`` (47-196 with ``with_w=False``, its step at 85-96),
``_crout_l_kernel`` (205) and ``crout_chol`` (211).  The fleet factorization
(ops/batched.py) calls it once per panel step on the diagonal blocks of all
members.  :func:`crout_chol` launches the hand-written CUDA kernel
``csrc/crout.cu`` for a CUDA tensor and runs :func:`crout_chol_reference`
for a CPU tensor.

Contracts (potrf 'L', as the TPU kernel's): only the lower triangle of each
tile is read; the strict upper of L is exactly 0; a non-positive pivot gives
NaN through the arithmetic, with no clamp and no early exit, in its tile
only, so that tile's L[-1, -1] is NaN.
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
    _check(A, None)
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
    _check(A, out)
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


def _check(A, out):
    if A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[0] == 0 or A.shape[1] == 0:
        raise ValueError(f"crout_chol: shape {tuple(A.shape)} must be (B, b, b), B, b >= 1")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"crout_chol: unsupported device {A.device}")
    for name, t in [("A", A)] + ([("out", out)] if out is not None else []):
        if t.shape != A.shape or t.dtype != A.dtype or t.device != A.device:
            raise ValueError(f"crout_chol: {name} must match A's shape, dtype and device")
        # rows contiguous: the kernel indexes t[i * stride(0) + r * stride(1) + c]
        if t.shape[2] > 1 and (t.stride(2) != 1 or t.stride(1) < t.shape[2]):
            raise ValueError(f"crout_chol: {name} must be a row-major view (strides {t.stride()})")
