"""K2's plain version summed in the order of the card's split products, for
the tests of gpr_tpu_torch/ops/fullchol.py (on the CPU and on the card; it
imports no JAX).

Each 128-row tile's pieces (``fullchol._split_pieces``), sums of 128-deep
products, are subtracted from S in turn, as csrc/fullchol.cu's strip kernel
subtracts the scratch slots; ``fullchol.panel_update_reference`` subtracts
one product.
"""

import torch

from gpr_tpu_torch.ops import fullchol

PANEL = fullchol.PANEL


def panel_update_split(L, j, src, *gram, blocks):
    """K2's plain version (in place on L) with the update split as the card
    splits it on ``blocks`` blocks."""
    n_pad = L.shape[0]
    jp, je = j * PANEL, (j + 1) * PANEL
    S = torch.zeros_like(L)  # no earlier columns: the plain version writes S itself
    fullchol.panel_update_reference(S, j, src, *gram)
    L[:, jp:je] = S[:, jp:je]
    if not j:
        return
    for t, pieces in enumerate(fullchol._split_pieces(n_pad, j, blocks)):
        rows = slice(jp + t * PANEL, jp + (t + 1) * PANEL)
        for _, lo, hi in pieces:
            run = torch.zeros((PANEL, PANEL), dtype=L.dtype, device=L.device)
            for k in range(lo, hi, PANEL):
                run += L[rows, k:k + PANEL] @ L[jp:je, k:k + PANEL].T
            L[rows, jp:je] -= run


def cholesky_split(src, *gram, sms=132):
    """(L, W) from the plain versions of K2-K4, K2 summed in the split order
    of a card with ``sms`` SMs.  ``gram`` empty is matrix mode, else
    (form, sigma, scale, third, diag) and src = X."""
    n_pad = fullchol.padded_size(src.shape[0])

    def update(L, j, s, *g):
        panel_update_split(L, j, s, *g, blocks=fullchol._split_plan(n_pad, j, sms))

    return fullchol._factor(src, n_pad, gram, (update, fullchol.diag_factor_inv_reference,
                                               fullchol.panel_solve_reference))
