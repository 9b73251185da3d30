"""Lower-triangle SYRK update ``S = A22 - L21 L21^T`` (kernel K5).

Mirrors gpr_tpu/ops/pallas_syrk.py:73-178 (``_syrk_kernel``,
``syrk_update``): the trailing update of the blocked Cholesky
(ops/blocked.py), which reads only the lower triangle of its Schur
complement, so only the lower output tiles are computed.  :func:`syrk_update`
launches the hand-written CUDA kernel ``csrc/syrk.cu`` for a CUDA tensor and
runs :func:`syrk_update_reference` for a CPU tensor.

The kernel's output contract: the lower triangle is A22 - L21 L21^T; the
strict upper of ``out`` is never written.  Unlike the TPU kernel, which
needs m % bm == 0 and k % bk == 0, any (m, k) and any row-major view
(``stride(1) == 1``) is accepted: the recursion passes views of one n x n
buffer (rows of odd stride, not 16-byte aligned) and updates A22 in place
(``out=A22``).  The wrapper copies L21 once into an aligned buffer of
:data:`TILE`-row and :data:`SLICE`-column multiples, zero-filled, which the
kernel's tensor-core tile loads 16 bytes at a time (csrc/syrk.cu).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

_INT_MAX = 2**31 - 1
TILE = 128  # output tile edge of the kernel
SLICE = 32  # depth of its k-slices


def syrk_update_reference(A22: torch.Tensor, L21: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K5: the full A22 - L21 L21^T, a valid value
    for an output whose strict upper triangle is undefined."""
    return A22 - L21 @ L21.mT


def syrk_update(A22: torch.Tensor, L21: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5: ``A22 - L21 L21^T`` on the lower triangle, A22 (m, m), L21 (m, k),
    float32, into ``out`` (a new (m, m) tensor when None).  ``out`` may be
    A22 itself; it must share no memory with L21.  A CUDA tensor launches
    the kernel; a CPU tensor runs :func:`syrk_update_reference`."""
    m, _ = _check(A22, L21, out)
    if A22.device.type == "cpu":
        S = syrk_update_reference(A22, L21)
        return S if out is None else out.copy_(S)
    if out is None:
        out = torch.empty((m, m), dtype=torch.float32, device=A22.device)
    Lp = _aligned(L21)
    _cuda.SYRK_UPDATE.launch(
        A22.device, A22.data_ptr(), A22.stride(0), Lp.data_ptr(), Lp.shape[1],
        out.data_ptr(), out.stride(0), m, Lp.shape[1],
    )
    return out


def _aligned(L21: torch.Tensor) -> torch.Tensor:
    """L21 (m, k) in a new contiguous buffer of ceil(m / TILE) TILE rows and
    ceil(k / SLICE) SLICE columns, zeros outside L21."""
    m, k = L21.shape
    Lp = torch.empty((-(-m // TILE) * TILE, -(-k // SLICE) * SLICE), dtype=torch.float32,
                     device=L21.device)
    Lp[:m, :k] = L21
    Lp[:m, k:] = 0.0
    Lp[m:] = 0.0
    return Lp


def _check(A22, L21, out):
    if A22.ndim != 2 or L21.ndim != 2 or A22.shape[0] != A22.shape[1] \
            or L21.shape[0] != A22.shape[0] or A22.shape[0] == 0:
        raise ValueError(f"syrk_update: shapes {tuple(A22.shape)} and {tuple(L21.shape)} "
                         "must be (m, m) and (m, k), m >= 1")
    m, k = L21.shape
    named = [("A22", A22), ("L21", L21)] + ([("out", out)] if out is not None else [])
    if out is not None and out.shape != (m, m):
        raise ValueError(f"syrk_update: out must be ({m}, {m}), got {tuple(out.shape)}")
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"syrk_update: {name} must be float32, got {t.dtype}")
        if t.device != A22.device:
            raise ValueError("syrk_update: A22, L21 and out must be on one device")
        # rows contiguous, rows apart by at least a row: the kernel indexes
        # t[r * stride(0) + c]
        if t.shape[1] > 1 and t.stride(1) != 1 or t.shape[0] > 1 and t.stride(0) < t.shape[1]:
            raise ValueError(f"syrk_update: {name} must be a row-major view "
                             f"(strides {t.stride()})")
        if t.stride(0) > _INT_MAX or t.shape[0] > _INT_MAX:
            raise ValueError(f"syrk_update: {name} exceeds 32-bit indexing")
    if A22.device.type not in ("cpu", "cuda"):
        raise ValueError(f"syrk_update: unsupported device {A22.device}")
    return m, k
