"""Left-looking panel Cholesky, in Gram mode or matrix mode (kernels K2-K4).

Mirrors gpr_tpu/ops/pallas_fullchol.py:1125-1481 (``_call_fused``,
``cholesky_fused``, ``gram_cholesky_fused``, ``safe_gram_cholesky_fused``,
``cho_solve_panels``).  The TPU runs the whole factorization as one Pallas
dispatch; here the panels of ``PANEL`` columns are walked one by one.  Per
panel j:

  :func:`panel_update`     (K2) P = S - L[rows, :jp] L[panel, :jp]^T into
                           column block j of L, zeros above it.  S is built
                           from X (Gram mode, with the pad masking of
                           pallas_fullchol.py:788-804) or read from the lower
                           triangle of A (matrix mode).  On the card the
                           product runs in three stages: the products over
                           k < jp - 128, their k range split into pieces
                           dealt out evenly to the SMs (:func:`_split_plan`);
                           the last 128-deep slice, k in [jp - 128, jp); the
                           strip, S minus the pieces in a fixed order, the
                           last slice last (:func:`_split_pieces`).
  :func:`diag_factor_inv`  (K3) L_jj = chol(P_jj), W_j = inv(L_jj).
  :func:`panel_solve`      (K4) L[r, panel] = P[r, :] W_j^T for r below.

Each step launches its CUDA kernel (csrc/fullchol.cu) for a CUDA tensor and
runs its ``*_reference`` torch version for a CPU tensor.  A factorization on
the card runs them with a one-panel lookahead (:func:`_lookahead`), stepped
by one C call so that the host enqueues a panel in microseconds: the
products of panel j + 1 read only columns that are final once panel j - 1
is solved, so they run on a second stream beside K3 and K4 of panel j, and
the last slice and the strip of panel j + 1 follow K4 on the current stream.
That moves no sum, only when it runs: L is bit-identical to the stages run
one after another.  Contracts, as on the TPU: only the lower triangle of A is
read; the strict upper of L is exactly 0; a non-positive pivot NaN-poisons
L[-1, -1].

The panel width is 128 (the TPU's 512 is TPU tuning, exact.py:408): the
128x128 diagonal block and its inverse fit one block's shared memory.  Gram
mode pads n to a multiple of 128.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count, host_wait
from . import _cuda
from .gram import FORMS, form_value

PANEL = 128
GRAM_FORMS = ("gaussian", "rq", "matern12", "matern32", "matern52")


def padded_size(n: int) -> int:
    return -(-n // PANEL) * PANEL


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _side_stream(index: int):
    """The lookahead's second stream on card ``index``."""
    return torch.cuda.Stream(torch.device("cuda", index))


def _split_plan(n_pad: int, j: int, sms: int) -> int:
    """How many blocks K2's products take for panel ``j`` on a card of
    ``sms`` SMs: 0 for the first two panels (no columns before panel j - 1),
    else one per 128-deep k slice below jp - 128 of each 128-row tile below
    the panel, up to one block an SM but one (a block fills an SM; K3 of
    the panel before runs on the one left over).  The tiles' slices, j - 1
    each, are dealt out to the blocks in order, as evenly as whole slices
    allow (:func:`_split_pieces`), so that every SM gets the same work."""
    return min((j - 1) * ((n_pad - j * PANEL) // PANEL), max(sms - 1, 1)) if j > 1 else 0


def _split_pieces(n_pad: int, j: int, blocks: int) -> list:
    """For each 128-row tile t of panel ``j``, the pieces its k range [0, jp)
    is split into, in the order K2 subtracts them: (slot, lo, hi), k in
    [lo, hi).  Block b of the products takes slices [b U / blocks, (b + 1) U
    / blocks) of the U = tiles * (j - 1) below jp - 128 in tile-major order
    and writes the piece it computes of tile t to scratch slot b + t
    (csrc/fullchol.cu::panel_products_kernel); the last slice, [jp - 128,
    jp), comes last, in slot s0 + t after the products' s0 slots."""
    tiles = (n_pad - j * PANEL) // PANEL
    pieces = [[] for _ in range(tiles)]
    if j == 0:
        return pieces
    ks = j - 1
    units = tiles * ks
    for b in range(blocks):
        u0, u1 = b * units // blocks, (b + 1) * units // blocks
        for t in range(u0 // ks, (u1 - 1) // ks + 1):
            lo, hi = max(u0, t * ks) - t * ks, min(u1, (t + 1) * ks) - t * ks
            pieces[t].append((b + t, PANEL * lo, PANEL * hi))
    s0 = blocks + tiles - 1 if blocks else 0
    for t in range(tiles):
        pieces[t].append((s0 + t, PANEL * ks, PANEL * j))
    return pieces


def _scratch_tiles(n_pad: int, j: int, sms: int) -> int:
    """128x128 partial tiles K2 needs for panel ``j``: the products' slots
    b + t, then one last slice a tile; at most (sms - 1) + 2 * 127 (25 MB at
    n_pad = 16384 on 132 SMs)."""
    if j == 0:
        return 0
    blocks, tiles = _split_plan(n_pad, j, sms), (n_pad - j * PANEL) // PANEL
    return (blocks + tiles - 1 if blocks else 0) + tiles


# ---------------------------------------------------------------------------
# one panel step each: kernel wrapper + plain version
# ---------------------------------------------------------------------------

def panel_update_reference(L, j, src, form=None, sigma=1.0, scale=1.0, third=1.0,
                           diag=0.0) -> None:
    """Plain torch version of K2 (in place on L), the update as one product."""
    n_pad = L.shape[0]
    jp, je = j * PANEL, (j + 1) * PANEL
    L[:jp, jp:je] = 0.0
    if form is None:
        S = src[jp:, jp:je].clone()
        low = torch.tril(S[:PANEL])
        S[:PANEL] = low + torch.tril(low, -1).T  # mirror the diagonal block
    else:
        n_true = src.shape[0]
        Xp = torch.zeros((n_pad, src.shape[1]), dtype=src.dtype, device=src.device)
        Xp[:n_true] = src
        x, y = Xp[jp:], Xp[jp:je]
        d2 = torch.clamp((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2.0 * (x @ y.T),
                         min=0.0)
        S = form_value(form, d2, sigma, scale, third)
        rows = torch.arange(jp, n_pad, device=L.device)[:, None]
        cols = torch.arange(jp, je, device=L.device)[None, :]
        S = torch.where((rows >= n_true) | (cols >= n_true), 0.0, S)
        S = S + torch.where(rows == cols, diag + torch.where(rows >= n_true, scale * scale, 0.0), 0.0)
    if j:
        S = S - L[jp:, :jp] @ L[jp:je, :jp].T
    L[jp:, jp:je] = S


def panel_update(L, j, src, form=None, sigma=1.0, scale=1.0, third=1.0, diag=0.0) -> None:
    """K2 for panel ``j`` (in place on L), its three kernels in stream order
    on the current stream.  ``form=None`` is matrix mode, src = A (n_pad,
    n_pad); otherwise Gram mode, src = X (n_true, d).  On the card the split
    partials go to scratch from PyTorch's caching allocator."""
    n_pad = _check_factor(L, "panel_update")
    _check_src(src, n_pad, form)
    if L.device.type == "cpu":
        return panel_update_reference(L, j, src, form, sigma, scale, third, diag)
    sms = _sm_count(L.device.index)
    scratch = torch.empty((max(_scratch_tiles(n_pad, j, sms), 1), PANEL, PANEL),
                          dtype=torch.float32, device=L.device)
    code = -1 if form is None else FORMS.index(form)
    _cuda.PANEL_UPDATE.launch(
        L.device, src.data_ptr(), L.data_ptr(), scratch.data_ptr(), n_pad, src.shape[0],
        src.shape[1], j, _split_plan(n_pad, j, sms), code, float(sigma), float(scale),
        float(third), float(diag),
    )


def diag_factor_inv_reference(L, W, j) -> None:
    """Plain torch version of K3: unblocked right-looking Cholesky of the
    diagonal block (sqrt of a non-positive pivot gives NaN, kept), then
    W_j = inv(L_jj) with an exact-zero strict upper."""
    jp, je = j * PANEL, (j + 1) * PANEL
    A = torch.tril(L[jp:je, jp:je])
    for k in range(PANEL):
        A[k, k] = torch.sqrt(A[k, k])
        A[k + 1:, k] /= A[k, k]
        A[k + 1:, k + 1:] -= torch.outer(A[k + 1:, k], A[k + 1:, k])
    Ljj = torch.tril(A)
    eye = torch.eye(PANEL, dtype=L.dtype, device=L.device)
    W[j] = torch.tril(torch.linalg.solve_triangular(Ljj, eye, upper=False))
    L[jp:je, jp:je] = Ljj


def diag_factor_inv(L, W, j) -> None:
    """K3 for panel ``j`` (in place on L and W)."""
    n_pad = _check_factor(L, "diag_factor_inv")
    _check_w(W, L)
    if L.device.type == "cpu":
        return diag_factor_inv_reference(L, W, j)
    _cuda.DIAG_FACTOR_INV.launch(L.device, L.data_ptr(), W.data_ptr(), n_pad, j)


def panel_solve_reference(L, W, j) -> None:
    """Plain torch version of K4 (in place on L)."""
    jp, je = j * PANEL, (j + 1) * PANEL
    L[je:, jp:je] = L[je:, jp:je] @ W[j].T


def panel_solve(L, W, j) -> None:
    """K4 for panel ``j`` (in place on L); nothing to do for the last."""
    n_pad = _check_factor(L, "panel_solve")
    _check_w(W, L)
    if (j + 1) * PANEL >= n_pad:
        return
    if L.device.type == "cpu":
        return panel_solve_reference(L, W, j)
    _cuda.PANEL_SOLVE.launch(L.device, L.data_ptr(), W.data_ptr(), n_pad, j)


def _check_factor(L, name) -> int:
    if L.ndim != 2 or L.shape[0] != L.shape[1] or L.shape[0] % PANEL:
        raise ValueError(f"{name}: L must be (n_pad, n_pad) with n_pad % {PANEL} == 0")
    if L.dtype != torch.float32 or not L.is_contiguous():
        raise ValueError(f"{name}: L must be contiguous float32")
    if L.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {L.device}")
    return L.shape[0]


def _check_w(W, L):
    nc = L.shape[0] // PANEL
    if W.shape != (nc, PANEL, PANEL) or W.dtype != torch.float32 or not W.is_contiguous():
        raise ValueError(f"W must be contiguous float32 of shape ({nc}, {PANEL}, {PANEL})")
    if W.device != L.device:
        raise ValueError("L and W must be on one device")


def _check_src(src, n_pad, form):
    if src.dtype != torch.float32 or not src.is_contiguous() or src.ndim != 2:
        raise ValueError("panel_update: src must be a contiguous float32 matrix")
    if form is None:
        if src.shape != (n_pad, n_pad):
            raise ValueError(f"panel_update: A must be ({n_pad}, {n_pad})")
    elif form not in GRAM_FORMS:
        raise ValueError(f"panel_update: unsupported form {form!r}")
    elif not (n_pad - PANEL < src.shape[0] <= n_pad) or src.shape[1] == 0:
        raise ValueError(f"panel_update: X of shape {tuple(src.shape)} does not pad to {n_pad}")


# ---------------------------------------------------------------------------
# the factorization
# ---------------------------------------------------------------------------

def _factor(src, n_pad, gram, steps):
    L = torch.empty((n_pad, n_pad), dtype=torch.float32, device=src.device)
    W = torch.empty((n_pad // PANEL, PANEL, PANEL), dtype=torch.float32, device=src.device)
    if steps is _KERNEL_STEPS and src.device.type == "cuda":
        _lookahead(L, W, src, gram)
        return L, W
    update, factor_inv, solve = steps
    for j in range(n_pad // PANEL):
        update(L, j, src, *gram)
        factor_inv(L, W, j)
        solve(L, W, j)
    return L, W


def _lookahead(L, W, src, gram) -> None:
    """The kernels' factorization on the card, in place on L and W, with a
    one-panel lookahead, stepped by csrc/fullchol.cu::gpr_factor_lookahead
    in one call.  Per panel j on the current stream: K2's last slice (after
    K4 of panel j - 1), a wait for the products of panel j, the strip, K3,
    K4.  After the strip, the products of panel j + 1 over k < jp (the
    columns solved by now) start on a second stream on all SMs but one
    (:func:`_split_plan`), so that they run beside K3 (on the one left over)
    and K4; the strip of panel j + 1 waits for them by an event.  Panels use
    two scratch buffers in turn, taken here on the current stream; the second
    stream is joined to it before the call returns."""
    n_pad = L.shape[0]
    nc = n_pad // PANEL
    _check_src(src, n_pad, gram[0] if gram else None)
    form, sigma, scale, third, diag = gram or (None, 1.0, 1.0, 1.0, 0.0)
    sms = _sm_count(L.device.index)
    plan = (ctypes.c_int * nc)(*(_split_plan(n_pad, j, sms) for j in range(nc)))
    tiles = max(max(_scratch_tiles(n_pad, j, sms) for j in range(nc)), 1)
    part = torch.empty((2, tiles, PANEL, PANEL), dtype=torch.float32, device=L.device)
    launches = {_cuda.PANEL_UPDATE: nc + (nc - 1) + max(nc - 2, 0),  # strips, last slices, products
                _cuda.DIAG_FACTOR_INV: nc, _cuda.PANEL_SOLVE: nc - 1}
    _cuda.FACTOR_LOOKAHEAD.launch(
        L.device, launches, src.data_ptr(), L.data_ptr(), W.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), plan, n_pad, src.shape[0], src.shape[1],
        -1 if form is None else FORMS.index(form), float(sigma), float(scale), float(third),
        float(diag), _side_stream(L.device.index).cuda_stream,
    )


_KERNEL_STEPS = (panel_update, diag_factor_inv, panel_solve)
_REFERENCE_STEPS = (panel_update_reference, diag_factor_inv_reference, panel_solve_reference)


def _gram_args(X, form, sigma, scale, third, diag):
    if form not in GRAM_FORMS:
        raise ValueError(f"gram_cholesky_fused: unsupported form {form!r}")
    if X.ndim != 2 or X.shape[0] == 0 or X.shape[1] == 0:
        raise ValueError(f"gram_cholesky_fused: X must be (n, d), got {tuple(X.shape)}")
    return padded_size(X.shape[0]), (form, sigma, scale, third, diag)


def cholesky_fused(A) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A`` (n, n) float32, n % 128 == 0; only
    the lower triangle is read and the strict upper of L is exactly 0."""
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] % PANEL or A.shape[0] == 0:
        raise ValueError(f"cholesky_fused: shape {tuple(A.shape)} must be (n, n), n % {PANEL} == 0")
    return _factor(A, A.shape[0], (), _KERNEL_STEPS)[0]


def gram_cholesky_fused(X, sigma, scale, third, diag, *, form: str = "gaussian",
                        return_winv: bool = False):
    """chol(K(X, X) + diag I) without the Gram matrix ever being stored: each
    panel strip is built from X.  For n not a multiple of 128 the factor is
    (n_pad, n_pad) over [[K, 0], [0, scale^2 I]] + diag I; ``L[:n, :n]`` is
    exact and a zero-padded right-hand side solves to an exact-zero tail.
    With ``return_winv`` also returns W (nc, 128, 128), W_j = inv(L_jj)."""
    n_pad, gram = _gram_args(X, form, sigma, scale, third, diag)
    L, W = _factor(X, n_pad, gram, _KERNEL_STEPS)
    return (L, W) if return_winv else L


def fused_cholesky_reference(src, *, form=None, sigma=1.0, scale=1.0, third=1.0,
                             diag=0.0):
    """(L, W) from the plain torch version of every step, on any device: the
    reference the kernels are held against.  ``form=None`` is matrix mode."""
    if form is None:
        return _factor(src, src.shape[0], (), _REFERENCE_STEPS)
    n_pad, gram = _gram_args(src, form, sigma, scale, third, diag)
    return _factor(src, n_pad, gram, _REFERENCE_STEPS)


def safe_gram_cholesky_fused(X, sigma, scale, third, noise, *, form: str = "gaussian",
                             initial_jitter: float = 0.0, max_tries: int = 6,
                             return_winv: bool = False):
    """(L, jitter) or (L, W, jitter): :func:`gram_cholesky_fused` with jitter
    escalation.  A failed attempt re-runs the whole factorization with
    ``noise + j``, j starting at ``initial_jitter`` (or eps * max(scale^2 +
    noise, 1): every form is stationary with k(x, x) = scale^2) and growing
    10x per retry.  The success path is one factorization and one scalar
    read, L[-1, -1]."""
    eps = float(torch.finfo(torch.float32).eps)
    L, W = gram_cholesky_fused(X, sigma, scale, third, noise, form=form, return_winv=True)
    count("factor.fullchol")
    jitter = 0.0
    if not _last_pivot_ok(L):
        base = initial_jitter if initial_jitter > 0 else eps * max(scale * scale + noise, 1.0)
        for tries in range(max_tries):
            jitter = base if tries == 0 else jitter * 10.0
            L, W = gram_cholesky_fused(X, sigma, scale, third, noise + jitter, form=form,
                                       return_winv=True)
            count("factor.fullchol")
            count("retry.fullchol")
            if _last_pivot_ok(L):
                break
    host_wait("fullchol.jitter", X)  # a blocking copy to the card
    jit = torch.tensor(jitter, dtype=torch.float32, device=X.device)
    return (L, W, jit) if return_winv else (L, jit)


def _last_pivot_ok(L) -> bool:
    host_wait("fullchol.ok", L)
    return bool(torch.isfinite(L[-1, -1]))


def cho_solve_panels(L, W, B) -> torch.Tensor:
    """Solve (L L^T) X = B with the panel-diagonal inverses W (nc, p, p): two
    block-substitution sweeps of plain matrix products.

      forward  (j ascending):  y_j = W_j (B_j - L[j, :j] y_{<j})
      backward (j descending): x_j = W_j^T (y_j - L[>j, j]^T x_{>j})
    """
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    nc, p, _ = W.shape
    Y = torch.empty_like(B)
    for j in range(nc):
        rhs = B[j * p:(j + 1) * p]
        if j:
            rhs = rhs - L[j * p:(j + 1) * p, :j * p] @ Y[:j * p]
        Y[j * p:(j + 1) * p] = W[j] @ rhs
    Xs = torch.empty_like(B)
    for j in reversed(range(nc)):
        rhs = Y[j * p:(j + 1) * p]
        if j + 1 < nc:
            rhs = rhs - L[(j + 1) * p:, j * p:(j + 1) * p].T @ Xs[(j + 1) * p:]
        Xs[j * p:(j + 1) * p] = W[j].T @ rhs
    return Xs[:, 0] if squeeze else Xs
