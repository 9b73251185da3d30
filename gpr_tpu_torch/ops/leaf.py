"""Whole-leaf Cholesky: K12 leaf_chol, K13 leaf_chol_wi and K14 tri_inv_leaf.

Mirrors gpr_tpu/ops/pallas_leaf.py: ``leaf_cholesky`` (85; kernel
``_leaf_kernel``, 47), ``leaf_usable`` (106), ``leaf_cholesky_wi`` (207;
``_leaf_wi_kernel``, 118) and ``tri_inv_leaf`` (278; ``_tri_inv_kernel``,
239).  Each takes one recursion leaf of the blocked Cholesky (ops/blocked.py),
(n, n) with n % 256 == 0 and n <= 1024, and raises ``ValueError`` on any other
shape, as JAX does.  ``leaf_cholesky_wi`` is the one the recursion dispatches
under ``GPR_CHOL_LEAF_INV=1``: its W = L^-1 turns the recursion's leaf solves
into products.

Each wrapper launches its hand-written CUDA kernel (``csrc/leaf.cu``) for a
CUDA float32 tensor, raises for another CUDA dtype, and runs its plain torch
version (``*_reference``) for a CPU tensor of any dtype, as JAX runs its
kernels in interpret mode on the CPU.  K12 holds the leaf in the shared
memory of one thread-block cluster of n / 64 CTAs (16 at n = 1024, a
non-portable size; :func:`max_active_clusters` asks the card how many it
places) and walks 32-wide diagonal blocks.  K14 is one launch of a
persistent grid that takes work items by ticket: the 64-wide diagonal blocks
(two warps' 32-wide inverses and one doubling level each), then per doubling
level the 64x64 tiles of T = C inv(A) and of W_CA = -inv(D) T, each sum cut
into pieces (32 to 128 terms, deeper at the higher levels) whose partials
each consumer adds in a fixed order as it stages them; its scratch is the
pieces' slots (:func:`_inv_scratch`), and its ticket and flags live in a
small buffer a stream that each launch leaves zero (:func:`_flags`).  K13 is
K12's factor, then K14's launch on that L, so its W is ``tri_inv_leaf`` of
its L bit for bit.  The plain versions walk 64-wide diagonal blocks: the
diagonal block by ``torch.linalg.cholesky_ex`` (NaN where it fails) and its
inverse by a triangular solve, the column solve and trailing update by
products, and W by the same block doubling (``_inverse_from_blocks``).

Contracts (potrf 'L', as the TPU kernels'): only the lower triangle of the
input is read; the outputs' strict upper triangles are exactly 0; a
non-positive pivot makes L[-1, -1] NaN and W non-finite.  The factor may be
written in place over its input (``out=A``), as JAX aliases input to output.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

BLOCK = 64  # csrc/leaf.cu: kInvBase, K13's and K14's diagonal block and the plain versions'
ALIGN = 256  # the JAX package's shape gate: its 256-wide diagonal block
MAX_N = 1024  # the largest leaf (JAX: the whole leaf in VMEM)
CLUSTER_BLOCK = 32  # csrc/chol.cuh: kCholNb, K12's diagonal block


def leaf_usable(n: int, dtype: torch.dtype, device) -> bool:
    """Whether the recursion gives an (n, n) leaf to :func:`leaf_cholesky_wi`
    (pallas_leaf.py:106-113 and blocked.py:213-221): n % 256 == 0 and n <=
    1024, float32 on the card (the kernel), any dtype on the CPU (the plain
    version, as JAX's interpret branch)."""
    if n <= 0 or n % ALIGN or n > MAX_N:
        return False
    kind = torch.device(device).type
    return kind == "cpu" or (kind == "cuda" and dtype == torch.float32)


def _chol_block(D: torch.Tensor) -> torch.Tensor:
    """Factor of the lower triangle of one diagonal block; NaN if it fails."""
    low = torch.tril(D)
    L, info = torch.linalg.cholesky_ex(low + torch.tril(low, -1).mT)
    return torch.where(info != 0, torch.nan, L)


def _inverse_from_blocks(L: torch.Tensor, V) -> torch.Tensor:
    """W = L^-1 from the inverses V[k] of L's diagonal blocks by the kernels'
    doubling: at width w each pair of block ranges A, C (w blocks each, C
    possibly shorter) gets W_CA = -W_C (L_CA W_A).  Reads L's strictly lower
    blocks only."""
    n, b = L.shape[0], BLOCK
    nb = n // b
    W = torch.zeros_like(L)
    for k, Vk in enumerate(V):
        W[k * b:(k + 1) * b, k * b:(k + 1) * b] = Vk
    w = 1
    while w < nb:
        for a0 in range(0, nb, 2 * w):
            c0 = a0 + w
            if c0 >= nb:
                continue
            A, C = slice(a0 * b, c0 * b), slice(c0 * b, min(c0 + w, nb) * b)
            W[C, A] = -(W[C, C] @ (L[C, A] @ W[A, A]))
        w *= 2
    return W


def _factor_blocks(A: torch.Tensor):
    """(L, [V_k]) of the lower triangle of A by the kernels' right-looking
    schedule over 64-wide diagonal blocks."""
    n, b = A.shape[0], BLOCK
    S = torch.tril(A)  # the strict upper may hold anything, NaN included
    eye = torch.eye(b, dtype=A.dtype, device=A.device)
    V = []
    for k in range(0, n, b):
        e = k + b
        Lkk = _chol_block(S[k:e, k:e])
        Vk = torch.linalg.solve_triangular(Lkk, eye, upper=False)
        S[k:e, k:e] = Lkk
        if e < n:
            S[e:, k:e] = S[e:, k:e] @ Vk.mT
            S[e:, e:] -= S[e:, k:e] @ S[e:, k:e].mT
        V.append(Vk)
    return torch.tril(S), V


def leaf_cholesky_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K12 (and of JAX's ``_leaf_kernel``)."""
    _check("leaf_cholesky", A)
    return _factor_blocks(A)[0]


def leaf_cholesky_wi_reference(A: torch.Tensor):
    """Plain torch version of K13: (L, W = L^-1) from one factorization."""
    _check("leaf_cholesky_wi", A)
    L, V = _factor_blocks(A)
    return L, _inverse_from_blocks(L, V)


def tri_inv_leaf_reference(L: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K14: W = L^-1 of the lower triangle of L."""
    _check("tri_inv_leaf", L)
    b = BLOCK
    low = torch.tril(L)
    eye = torch.eye(b, dtype=L.dtype, device=L.device)
    V = [torch.linalg.solve_triangular(low[k:k + b, k:k + b], eye, upper=False)
         for k in range(0, L.shape[0], b)]
    return _inverse_from_blocks(low, V)


def leaf_cholesky(A: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K12: the lower Cholesky factor of the SPD leaf ``A`` into ``out`` (a
    new tensor when None; ``out`` may be ``A`` itself).  Both are row-major
    views (``stride(1) == 1``), so a leaf may sit inside a larger buffer."""
    n = _check("leaf_cholesky", A, out=out)
    if A.device.type == "cpu":
        L = leaf_cholesky_reference(A)
        return L if out is None else out.copy_(L)
    _kernel_dtype("leaf_cholesky", A)
    out = _new(A) if out is None else out
    _cuda.LEAF_CHOL.launch(A.device, A.data_ptr(), A.stride(0), out.data_ptr(), out.stride(0),
                           _workspace(A).data_ptr(), n)
    return out


def max_active_clusters(n: int, device="cuda") -> int:
    """How many of K12's thread-block clusters (n / 64 CTAs at the kernel's
    shared memory) the card can hold at once, by
    ``cudaOccupancyMaxActiveClusters``; 0 means it cannot place one, and a
    launch at this n would fail."""
    if n <= 0 or n % (2 * CLUSTER_BLOCK) or n > MAX_N:
        raise ValueError(f"max_active_clusters: n ({n}) must be a multiple of {2 * CLUSTER_BLOCK}, <= {MAX_N}")
    return _cuda.query("gpr_leaf_chol_clusters", torch.device(device), n)


def leaf_cholesky_wi(A: torch.Tensor, out: Optional[torch.Tensor] = None):
    """K13: (L, W = L^-1) of the SPD leaf ``A``; L goes into ``out`` (a new
    tensor when None; ``out`` may be ``A``, so that the leaf is factored in
    place), W into a new (n, n) tensor."""
    n = _check("leaf_cholesky_wi", A, out=out)
    if A.device.type == "cpu":
        L, W = leaf_cholesky_wi_reference(A)
        return (L if out is None else out.copy_(L)), W
    _kernel_dtype("leaf_cholesky_wi", A)
    out = _new(A) if out is None else out
    W = _new(A)
    ws = _workspace(A, _inv_scratch(n, A.device))
    _cuda.LEAF_CHOL_WI.launch(A.device, A.data_ptr(), A.stride(0), out.data_ptr(), out.stride(0),
                              W.data_ptr(), W.stride(0), ws.data_ptr(), _flags(A.device).data_ptr(), n)
    return out, W


def tri_inv_leaf(L: torch.Tensor) -> torch.Tensor:
    """K14: W = L^-1 of the lower-triangular leaf ``L`` (only its lower
    triangle is read), a new (n, n) tensor."""
    n = _check("tri_inv_leaf", L)
    if L.device.type == "cpu":
        return tri_inv_leaf_reference(L)
    _kernel_dtype("tri_inv_leaf", L)
    W = _new(L)
    ws = torch.empty(_inv_scratch(n, L.device), dtype=torch.float32, device=L.device)
    _cuda.TRI_INV_LEAF.launch(L.device, L.data_ptr(), L.stride(0), W.data_ptr(), W.stride(0), ws.data_ptr(),
                              _flags(L.device).data_ptr(), n)
    return W


def _new(A):
    return torch.empty(A.shape, dtype=torch.float32, device=A.device)


def _workspace(A, least=0):
    # K12's published tiles of every panel (nt x nt slots of 32 x 32) and their
    # scales, at least `least` floats: K13's inverse takes it as scratch after
    # the factor
    nt = A.shape[0] // CLUSTER_BLOCK
    return torch.empty(max(nt * (nt * CLUSTER_BLOCK * CLUSTER_BLOCK + CLUSTER_BLOCK), least),
                       dtype=torch.float32, device=A.device)


_SCRATCH = {}


def _inv_scratch(n, device) -> int:
    """Floats of K14's scratch at leaf size n (its pieces' slots), as the
    library computes it."""
    if n not in _SCRATCH:
        _SCRATCH[n] = _cuda.query("gpr_tri_inv_leaf_scratch", device, n)
    return _SCRATCH[n]


_FLAGS = {}


def _flags(device):
    """K14's ticket, arrival counts and ready flags on the current stream:
    zeroed once, and each launch leaves them zero again (its last CTA resets
    them), so a call makes no fill.  One buffer a stream, so that launches
    that may run at once never share one."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _FLAGS:
        ints = _cuda.query("gpr_tri_inv_leaf_flags", device)
        _FLAGS[key] = torch.zeros(ints, dtype=torch.int32, device=device)
    return _FLAGS[key]


def _kernel_dtype(name, A):
    if A.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32, got {A.dtype}")


def _check(name, A, out=None) -> int:
    n = A.shape[0] if A.ndim == 2 else -1
    if A.ndim != 2 or A.shape != (n, n) or n == 0 or n % ALIGN or n > MAX_N:
        raise ValueError(f"{name}: shape {tuple(A.shape)} must be (n, n), n % {ALIGN} == 0, "
                         f"n <= {MAX_N}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {A.device}")
    for label, t in (("A", A), ("out", out)):
        if t is None:
            continue
        if t.shape != A.shape or t.dtype != A.dtype or t.device != A.device:
            raise ValueError(f"{name}: {label} must match A's shape, dtype and device")
        # rows contiguous: the kernels index t[r * stride(0) + c]
        if t.stride(1) != 1 or t.stride(0) < n:
            raise ValueError(f"{name}: {label} must be a row-major view (strides {t.stride()})")
    if out is not None and out.data_ptr() == A.data_ptr() and out.stride() != A.stride():
        raise ValueError(f"{name}: out must be A itself or share no memory with it")
    return n
