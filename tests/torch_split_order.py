"""K2's plain version summed in the order of the card's split products, for
the tests of gpr_tpu_torch/ops/fullchol.py (on the CPU and on the card; it
imports no JAX).

Each 128-row tile's pieces (``fullchol._split_pieces``: the products' pieces,
then the last 128-deep slice), sums of 128-deep products, are subtracted
from S in turn, as csrc/fullchol.cu's strip kernel subtracts the scratch
slots; ``fullchol.panel_update_reference`` subtracts one product.
"""

import torch

from gpr_tpu_torch.ops import fullchol

PANEL = fullchol.PANEL


def _strip(L, j, src, *gram):
    """Column block j of S (zeros above the panel), from the plain version."""
    S = torch.zeros_like(L)  # no earlier columns: the plain version writes S itself
    fullchol.panel_update_reference(S, j, src, *gram)
    return S[:, j * PANEL:(j + 1) * PANEL]


def _piece(L, j, t, lo, hi):
    """The sum of tile t's 128-deep products over k in [lo, hi), in order."""
    rows = slice(j * PANEL + t * PANEL, j * PANEL + (t + 1) * PANEL)
    run = torch.zeros((PANEL, PANEL), dtype=L.dtype, device=L.device)
    for k in range(lo, hi, PANEL):
        run += L[rows, k:k + PANEL] @ L[j * PANEL:(j + 1) * PANEL, k:k + PANEL].T
    return run


def _subtract(L, j, sums):
    """Column block j of L minus each tile's sums, in order."""
    for t, runs in enumerate(sums):
        rows = slice(j * PANEL + t * PANEL, j * PANEL + (t + 1) * PANEL)
        for run in runs:
            L[rows, j * PANEL:(j + 1) * PANEL] -= run


def panel_update_split(L, j, src, *gram, blocks):
    """K2's plain version (in place on L) with the update split as the card
    splits it on ``blocks`` blocks."""
    L[:, j * PANEL:(j + 1) * PANEL] = _strip(L, j, src, *gram)
    pieces = fullchol._split_pieces(L.shape[0], j, blocks)
    _subtract(L, j, [[_piece(L, j, t, lo, hi) for _, lo, hi in ps] for t, ps in enumerate(pieces)])


def cholesky_split(src, *gram, sms=132):
    """(L, W) from the plain versions of K2-K4, K2 summed in the split order
    of a card with ``sms`` SMs.  ``gram`` empty is matrix mode, else
    (form, sigma, scale, third, diag) and src = X."""
    n_pad = fullchol.padded_size(src.shape[0])

    def update(L, j, s, *g):
        panel_update_split(L, j, s, *g, blocks=fullchol._split_plan(n_pad, j, sms))

    return fullchol._factor(src, n_pad, gram, (update, fullchol.diag_factor_inv_reference,
                                               fullchol.panel_solve_reference))


def cholesky_lookahead(src, *gram, sms=132):
    """(L, W) from the plain versions in the order of the card's lookahead
    (ops/fullchol.py::_lookahead): the products of panel j + 1 are summed
    right after the strip of panel j, before K3 and K4 of panel j write its
    columns; the last slice and the strip of panel j + 1 after them.  L
    starts as NaN, so that a read of an entry not yet written shows."""
    n_pad = fullchol.padded_size(src.shape[0])
    nc = n_pad // PANEL
    L = torch.full((n_pad, n_pad), float("nan"), dtype=torch.float32, device=src.device)
    W = torch.full((nc, PANEL, PANEL), float("nan"), dtype=torch.float32, device=src.device)
    ahead = {}
    for j in range(nc):
        pieces = fullchol._split_pieces(n_pad, j, fullchol._split_plan(n_pad, j, sms))
        last = [[_piece(L, j, t, *ps[-1][1:])] if j else [] for t, ps in enumerate(pieces)]
        sums = ahead.pop(j, [[] for _ in pieces])
        L[:, j * PANEL:(j + 1) * PANEL] = _strip(L, j, src, *gram)
        _subtract(L, j, [s + x for s, x in zip(sums, last)])
        if 0 < j < nc - 1:
            nxt = fullchol._split_pieces(n_pad, j + 1, fullchol._split_plan(n_pad, j + 1, sms))
            ahead[j + 1] = [[_piece(L, j + 1, t, lo, hi) for _, lo, hi in ps[:-1]]
                            for t, ps in enumerate(nxt)]
        fullchol.diag_factor_inv_reference(L, W, j)
        fullchol.panel_solve_reference(L, W, j)
    return L, W
