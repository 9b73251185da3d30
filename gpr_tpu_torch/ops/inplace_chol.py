"""In-place right-looking Cholesky: K16 rank_update_tiles, K17 panel_inplace
and K18 zero_upper, chained on one (n, n) buffer.

Mirrors gpr_tpu/ops/inplace_chol.py: ``rank_update_inplace`` (105; kernel
``_rank_update_call``, 53), ``panel_inplace`` (184; ``_panel_kernel_inplace``,
135), ``zero_upper_inplace`` (229; ``_tril_kernel``, 201) and
``cholesky_inplace`` (249), the route ``"inplace"`` of ops/linalg.py under
``GPR_CHOL_SCHEDULE=inplace``.  The schedule, for each w-wide column block
(w = 512, two b = 256 panels):

  1. ``panel_inplace``: factor the block's first panel (diagonal tile, then
     every row tile below against its inverse);
  2. ``rank_update_inplace`` (narrow, bm = bk = b): correct the next panel
     against the one just factored;
  3. ``panel_inplace``: factor the second panel;
  4. ``rank_update_inplace`` (wide, bm = bk = 512): one update of the lower
     512-tiles of the trailing square by the block's w columns;

and ``zero_upper_inplace`` at the end.  Each writes the buffer it reads, as
JAX aliases input to output; ``cholesky_inplace`` pays one defensive copy of
A, as JAX's eager call does, and runs the chain on that copy.  The tile lists
for an (n, w, b) are built once per device and cached there (JAX passes them
as scalar prefetch), so the 63 K16 calls of an n = 16384 factorization copy
nothing from the host.

Each function launches its hand-written CUDA kernel (``csrc/inplace.cu``: K16
on the 3xTF32 tensor-core tile of ``csrc/tc_tile.cuh``, K18; ``csrc/panel.cu``:
K17 on K15's two kernels, the diagonal tile factored and inverted on one
8-CTA thread-block cluster, then the rows below in 32-row blocks) for a CUDA
float32 buffer, raises for another CUDA dtype, and runs its plain torch version
(``*_reference``: tile-list ``addmm_`` updates, ``cholesky_ex`` +
``solve_triangular`` for the panel, ``tril_``) for a CPU tensor.  Contracts,
as JAX's: only the lower triangle of A is read (NaN or junk above it leaves
the factor bit-identical); the factor's strict upper is exactly 0; a
non-positive pivot makes L[-1, -1] NaN.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda
from .panel import TILE, WORKSPACE

WIDE = 512  # the trailing update's tile and zero_upper's (inplace_chol.py: st)


def _check_buffer(name: str, S: torch.Tensor) -> int:
    if S.ndim != 2 or S.shape[0] != S.shape[1] or S.shape[0] == 0:
        raise ValueError(f"{name}: S must be (n, n), got {tuple(S.shape)}")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {S.device}")
    if S.device.type == "cuda":
        if S.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got {S.dtype}")
        if not S.is_contiguous():
            raise ValueError(f"{name}: the kernel rewrites a contiguous buffer (strides {S.stride()})")
    return S.shape[0]


def _tiles(name: str, a, limit: int) -> np.ndarray:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype=np.int64).reshape(-1)
    if a.size == 0 or a.min() < 0 or a.max() >= limit:
        raise ValueError(f"{name}: tile coordinates must lie in [0, {limit}), got {a}")
    return a


def rank_update_reference(S: torch.Tensor, rows, cols, kcols, *, bm: int, bk: int) -> torch.Tensor:
    """Plain torch version of K16: one ``addmm_`` per listed target tile."""
    src = torch.cat([S[:, int(k) * bk:(int(k) + 1) * bk] for k in np.asarray(torch.as_tensor(kcols).cpu())],
                    dim=1)
    for i, j in zip(np.asarray(torch.as_tensor(rows).cpu()), np.asarray(torch.as_tensor(cols).cpu())):
        i, j = int(i), int(j)
        S[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm].addmm_(
            src[i * bm:(i + 1) * bm], src[j * bm:(j + 1) * bm].mT, alpha=-1)
    return S


def _rank_update_tiles(S: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, kcols: torch.Tensor,
                       bm: int, bk: int) -> torch.Tensor:
    """K16 on lists already checked and held as int32 tensors on S's device
    (the schedule's cached lists): the plain version on the CPU, the kernel
    on the card.  Only the checks that need no copy from the device."""
    if rows.numel() != cols.numel():
        raise ValueError("rank_update_inplace: rows and cols must have one length")
    if S.device.type == "cpu":
        return rank_update_reference(S, rows, cols, kcols, bm=bm, bk=bk)
    if bm % 128 or bk % 32:
        raise ValueError(f"rank_update_inplace: the kernel takes bm % 128 == 0 and bk % 32 == 0, "
                         f"got {bm}, {bk}")
    if S.data_ptr() % 16:  # cp.async copies 16-byte pieces of every source row
        raise ValueError("rank_update_inplace: the kernel needs S 16-byte aligned")
    _cuda.RANK_UPDATE_TILES.launch(S.device, S.data_ptr(), S.shape[0], rows.data_ptr(), cols.data_ptr(),
                                   kcols.data_ptr(), rows.numel(), kcols.numel(), bm, bk)
    return S


def rank_update_inplace(S: torch.Tensor, rows, cols, kcols, *, bm: int, bk: int) -> torch.Tensor:
    """K16: ``S[i, j] -= S[i, kc] @ S[j, kc]^T`` over tile pairs, in place;
    returns S.

    ``rows``/``cols``: equal-length (bm x bm) target-tile coordinates;
    ``kcols``: (bk-unit) contraction column tiles.  Every (rows[t], cols[t])
    pair must be unique, and no target tile may overlap the source tiles
    ``(*, kcols)``, as the factorization schedule guarantees (targets lie
    strictly right of the panel).  The whole target tile is updated, diagonal
    tiles included.  The lists, on the host or the device, are checked
    against n on the host and copied up as int32."""
    n = _check_buffer("rank_update_inplace", S)
    if bm <= 0 or bk <= 0 or n % bm or n % bk:
        raise ValueError(f"rank_update_inplace: n={n} must be a multiple of bm={bm} and bk={bk}")
    rows, cols = (_tiles("rank_update_inplace", a, n // bm) for a in (rows, cols))
    kcols = _tiles("rank_update_inplace", kcols, n // bk)
    if rows.size != cols.size:
        raise ValueError("rank_update_inplace: rows and cols must have one length")
    rows, cols, kcols = (torch.as_tensor(a.astype(np.int32), device=S.device) for a in (rows, cols, kcols))
    return _rank_update_tiles(S, rows, cols, kcols, bm, bk)


def panel_inplace_reference(S: torch.Tensor, c0t: int, *, b: int = TILE) -> torch.Tensor:
    """Plain torch version of K17: the diagonal tile by ``cholesky_ex`` of its
    mirrored lower triangle (NaN where that fails), the rows below by a
    triangular solve."""
    c0, e = c0t * b, (c0t + 1) * b
    low = torch.tril(S[c0:e, c0:e])
    L, info = torch.linalg.cholesky_ex(low + torch.tril(low, -1).mT)
    L = torch.where(info != 0, torch.nan, L)
    S[c0:e, c0:e] = L
    if e < S.shape[0]:
        S[e:, c0:e] = torch.linalg.solve_triangular(L.mT, S[e:, c0:e], upper=True, left=False)
    return S


def _panel_scratch(device: torch.device) -> torch.Tensor:
    """K17's scratch: W^T of the diagonal tile (TILE x TILE), then the
    diagonal kernel's workspace (csrc/panel.cu, as K15's)."""
    return torch.empty(TILE * TILE + WORKSPACE, dtype=torch.float32, device=device)


def _panel_inplace(S: torch.Tensor, c0t: int, scratch: torch.Tensor) -> None:
    """K17 on the card on a checked buffer, with a scratch from :func:`_panel_scratch`."""
    if S.data_ptr() % 16:  # the rows kernel stores float4s
        raise ValueError("panel_inplace: the kernel needs S 16-byte aligned")
    _cuda.PANEL_INPLACE.launch(S.device, S.data_ptr(), S.shape[0], int(c0t), scratch.data_ptr(),
                               scratch.data_ptr() + 4 * TILE * TILE)


def panel_inplace(S: torch.Tensor, c0t: int, *, b: int = TILE, sw: int = 8) -> torch.Tensor:
    """K17: factor the column panel at tile column ``c0t`` in place; returns
    S.  The diagonal (b, b) tile is factored from its lower triangle (its
    strict upper may hold junk; it comes back exactly 0), every row tile below
    becomes tile @ L_dd^-T.  ``sw`` is JAX's strip height, not used."""
    del sw
    n = _check_buffer("panel_inplace", S)
    if b <= 0 or n % b or not 0 <= c0t < n // b:
        raise ValueError(f"panel_inplace: n={n}, b={b}, c0t={c0t} need n % b == 0 and "
                         f"0 <= c0t < n / b")
    if S.device.type == "cpu":
        return panel_inplace_reference(S, c0t, b=b)
    if b != TILE:
        raise ValueError(f"panel_inplace: the kernel takes b = {TILE}, got {b}")
    _panel_inplace(S, c0t, _panel_scratch(S.device))
    return S


@functools.lru_cache(maxsize=32)
def _upper_tiles(n: int, bm: int, device: torch.device):
    """(ti, tj, dg) of zero_upper_inplace: the diagonal tiles (dg 1), then the
    strictly upper ones (inplace_chol.py:238-240)."""
    nt = n // bm
    coords = [(i, i, 1) for i in range(nt)]
    coords += [(i, j, 0) for i in range(nt) for j in range(i + 1, nt)]
    arr = torch.tensor(coords, dtype=torch.int32).T.contiguous().to(device)
    return arr[0], arr[1], arr[2]


def zero_upper_inplace(S: torch.Tensor, *, bm: int = WIDE) -> torch.Tensor:
    """K18: zero the strict upper triangle in place (diagonal tiles masked,
    strictly-upper tiles written without being read); returns S."""
    n = _check_buffer("zero_upper_inplace", S)
    if bm <= 0 or n % bm:
        raise ValueError(f"zero_upper_inplace: n={n} must be a multiple of bm={bm}")
    if S.device.type == "cpu":
        return S.tril_()
    if bm % 64:
        raise ValueError(f"zero_upper_inplace: the kernel takes bm % 64 == 0, got {bm}")
    ti, tj, dg = _upper_tiles(n, bm, S.device)
    _cuda.ZERO_UPPER.launch(S.device, S.data_ptr(), n, ti.data_ptr(), tj.data_ptr(), dg.data_ptr(),
                            ti.numel(), bm)
    return S


@functools.lru_cache(maxsize=32)
def schedule(n: int, w: int, b: int, device: torch.device):
    """The steps of :func:`cholesky_inplace` (inplace_chol.py:281-313), its
    tile lists int32 tensors on ``device``: ("panel", c) and ("update", rows,
    cols, kcols, bm), bm = bk, in order; zero_upper_inplace follows."""
    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    ntb, ntw, pw = n // b, n // w, w // b
    steps = []
    for kw in range(ntw):
        cb = kw * pw  # first panel tile column of this wide block
        for p in range(pw):
            c = cb + p
            if p > 0:
                # this strip (rows c.., column c) against the block's earlier panels
                rows = np.arange(c, ntb)
                steps.append(("update", ints(rows), ints(np.full_like(rows, c)),
                              ints(np.arange(cb, c)), b))
            steps.append(("panel", c))
        if kw + 1 < ntw:
            # the wide trailing update on 512-tiles: the lower tiles of the
            # trailing square, contracting over this block's w columns
            st = min(w, WIDE)
            t0 = (kw + 1) * (w // st)
            nt_tr = n // st - t0
            coords = np.asarray([(t0 + i, t0 + j) for i in range(nt_tr) for j in range(i + 1)])
            kcols = np.arange(kw * (w // st), (kw + 1) * (w // st))
            steps.append(("update", ints(coords[:, 0]), ints(coords[:, 1]), ints(kcols), st))
    return tuple(steps)


def cholesky_inplace(A: torch.Tensor, *, w: int = WIDE, b: int = TILE) -> torch.Tensor:
    """Lower Cholesky factor by the in-place wide-panel schedule.

    Reads only the lower triangle; returns a factor with an exact-zero strict
    upper.  ``w``: trailing-update width; ``b``: panel width.  Requires
    n % w == 0, w % b == 0, and w a multiple of 512 when w > 512
    (inplace_chol.py:268-273).  One copy of A is made; the chain rewrites it."""
    n = A.shape[0] if A.ndim == 2 else -1
    if A.ndim != 2 or A.shape != (n, n):
        raise ValueError(f"cholesky_inplace: A must be (n, n), got {tuple(A.shape)}")
    if n % w or w % b or (w > 512 and w % 512):
        raise ValueError(
            f"cholesky_inplace: n={n}, w={w}, b={b} need n%w==0, w%b==0, "
            "and w a multiple of 512 when w > 512"
        )
    S = A.clone(memory_format=torch.contiguous_format)
    _check_buffer("cholesky_inplace", S)
    if S.device.type == "cuda" and b != TILE:
        raise ValueError(f"cholesky_inplace: the kernel takes b = {TILE}, got {b}")
    # one K17 scratch for the factorization's n / b panels
    scratch = _panel_scratch(S.device) if S.device.type == "cuda" else None
    for step in schedule(n, w, b, S.device):
        if step[0] == "panel":
            if scratch is None:
                panel_inplace_reference(S, step[1], b=b)
            else:
                _panel_inplace(S, step[1], scratch)
        else:
            _, rows, cols, kcols, bm = step
            _rank_update_tiles(S, rows, cols, kcols, bm, bm)
    return zero_upper_inplace(S, bm=min(w, WIDE))
