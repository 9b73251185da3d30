"""The fused panel factor (kernel K15) and the two panel Cholesky schedules
built on it.

Mirrors gpr_tpu/ops/pallas_panel.py: ``panel_factor`` (163; kernel
``_panel_kernel``, 143, with ``_strip_factor``, 42, and ``_inv_upper``, 92),
``cholesky_panels`` (190) and ``cholesky_left_panels`` (220).  As in JAX the
schedules are not dispatched by the factorization routes: tests and
benchmarks reach them.  The in-place schedule (ops/inplace_chol.py, K17) runs
the same two kernels' device code on its panels in place (``csrc/panel.cu``).

:func:`panel_factor` launches the hand-written CUDA kernel ``csrc/panel.cu``
for a CUDA float32 panel, raises for another CUDA dtype or a tile other than
256, and runs :func:`panel_factor_reference` for a CPU tensor.  The kernel
reads the panel's top (b, b) block from its upper triangle, as rows, as
``_strip_factor`` does, factors it and forms W = L_dd^-1 on one 8-CTA
thread-block cluster (K19's factor, ``csrc/chol.cuh``), then computes the
rows A21 W^T in a second kernel, 32 rows a block.
The schedules' trailing and left products stay ``torch.matmul``, as JAX leaves
them to XLA (pallas_panel.py:208-211, 246-249).
"""

from __future__ import annotations

import torch

from . import _cuda

TILE = 256  # csrc/panel.cu: kPanel, the kernel's panel width
# csrc/panel.cu's workspace: the factor's 7 published panels (32 x 480 each,
# chol.cuh's slots) and the 8 diagonal blocks' inverses (32 x 32)
WORKSPACE = 7 * 32 * 480 + 8 * 32 * 32


def panel_factor_reference(P: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K15: ``[L_dd; L21]`` of the (n, b) panel ``P``,
    L_dd = chol of the top block symmetrized from its upper triangle (NaN
    where that fails), L21 = P[b:] L_dd^-T by a triangular solve."""
    b = P.shape[1]
    D = P[:b]
    L, info = torch.linalg.cholesky_ex(torch.triu(D) + torch.triu(D, 1).mT)
    L = torch.where(info != 0, torch.nan, L)
    L21 = torch.linalg.solve_triangular(L.mT, P[b:], upper=True, left=False)
    return torch.cat([L, L21])


def panel_factor(P: torch.Tensor, *, sw: int = 8, tile: int = TILE) -> torch.Tensor:
    """K15: factor an (n, b) Cholesky column panel; returns ``[L_dd; L21]``,
    a new (n, b) tensor.

    P's top (b, b) block is the (Schur-updated) diagonal block, read from its
    upper triangle; the rows below are A21.  b = P.shape[1] must equal
    ``tile`` and divide n (pallas_panel.py:170-174).  ``sw``, the TPU's strip
    height, is accepted for JAX's signature and not used: the kernel walks
    64-wide diagonal blocks."""
    del sw
    if P.ndim != 2:
        raise ValueError(f"panel_factor: panel shape {tuple(P.shape)} must be (k*{tile}, {tile})")
    n, b = P.shape
    if b != tile or n % tile != 0 or n == 0:
        raise ValueError(f"panel_factor: panel shape {tuple(P.shape)} must be (k*{tile}, {tile})")
    if P.device.type == "cpu":
        return panel_factor_reference(P)
    if P.device.type != "cuda":
        raise ValueError(f"panel_factor: unsupported device {P.device}")
    if P.dtype != torch.float32 or tile != TILE:
        raise ValueError(f"panel_factor: the kernel takes float32 panels of width {TILE}, got "
                         f"{P.dtype}, {tile}")
    if P.stride(1) != 1:
        P = P.contiguous()
    out = torch.empty((n, b), dtype=torch.float32, device=P.device)
    W = torch.empty((b, b), dtype=torch.float32, device=P.device)
    ws = torch.empty(WORKSPACE, dtype=torch.float32, device=P.device)
    _cuda.PANEL_FACTOR.launch(P.device, P.data_ptr(), P.stride(0), out.data_ptr(), W.data_ptr(),
                              ws.data_ptr(), n)
    return out


def _check_square(name: str, A: torch.Tensor, tile: int) -> int:
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"{name}: A must be square, got {tuple(A.shape)}")
    n = A.shape[0]
    if n % tile != 0:
        raise ValueError(f"{name}: n ({n}) must be a multiple of {tile}")
    return n


def cholesky_panels(A: torch.Tensor, *, tile: int = TILE) -> torch.Tensor:
    """Right-looking Cholesky on :func:`panel_factor`: factor the leading
    panel, then update the whole trailing square by one product, and repeat
    on it (pallas_panel.py:190-217)."""
    n = _check_square("cholesky_panels", A, tile)
    S = A
    blocks = []
    for _ in range(n // tile):
        Lp = panel_factor(S[:, :tile], tile=tile)
        blocks.append(Lp)
        if S.shape[0] > tile:
            L21 = Lp[tile:]
            S = S[tile:, tile:] - L21 @ L21.mT
    L = torch.zeros_like(A)
    for k, Lp in enumerate(blocks):
        L[k * tile:, k * tile:(k + 1) * tile] = Lp
    return L


def cholesky_left_panels(A: torch.Tensor, *, tile: int = TILE) -> torch.Tensor:
    """Left-looking Cholesky on :func:`panel_factor`: panel k is first
    corrected by one product against every factored column, then factored
    (pallas_panel.py:220-253)."""
    n = _check_square("cholesky_left_panels", A, tile)
    L = torch.zeros_like(A)
    for k in range(n // tile):
        j0 = k * tile
        P = A[j0:, j0:j0 + tile]
        if k > 0:
            P = P - L[j0:, :j0] @ L[j0:j0 + tile, :j0].mT
        L[j0:, j0:j0 + tile] = panel_factor(P, tile=tile)
    return L
