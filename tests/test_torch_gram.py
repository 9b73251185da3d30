"""The port's Gram tile math (gpr_tpu_torch.ops.gram, kernel K1's plain
version) against gpr_tpu.ops.pallas_gram.gram_pallas in interpret mode.

float32 inputs with |x|^2 ~ 5.  The TPU kernel's cross term runs at the
bf16x3 tier (pallas_gram.py:60-81), which leaves d2 off by up to ~2e-4 here
(most near the diagonal, where d2 cancels), while the port runs full float32.
Hence atol 3e-4 * scale^2 for the smooth forms, 1e-5 of the largest entry
for sqdist, and 5e-3 * scale^2 for matern12, whose r = sqrt(d2) cusp turns a
d2 error e near the diagonal into sqrt(e) (pallas_gram.py:63-68).
"""

import numpy as np
import pytest
import torch

from gpr_tpu.ops.pallas_gram import gram_pallas
from gpr_tpu_torch.ops import gram as gop

PARAMS = dict(sigma=1.3, scale=1.1, diag=0.37)
THIRD = {"rq": 2.0, "periodic": 0.7}


def _tol(form, K):
    if form == "sqdist":
        return 1e-5 * np.abs(K).max()
    return (5e-3 if form == "matern12" else 3e-4) * PARAMS["scale"] ** 2


@pytest.mark.parametrize("form", gop.FORMS)
@pytest.mark.parametrize("tril", [False, True])
def test_matches_pallas_interpret(form, tril, rng):
    n, m, d = 300, (300 if tril else 170), 5  # ragged against the 256 tiles
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = X if tril else rng.standard_normal((m, d)).astype(np.float32)
    third = THIRD.get(form, 1.0)
    Kj = np.asarray(gram_pallas(
        X, Y, PARAMS["sigma"], PARAMS["scale"], third, PARAMS["diag"], form=form,
        interpret=True, tril=tril,
    ))
    Kt = gop.gram(torch.tensor(X), torch.tensor(Y), PARAMS["sigma"], PARAMS["scale"], third,
                  PARAMS["diag"], form=form, tril=tril).numpy()
    assert Kt.dtype == np.float32 and Kt.shape == (n, m)
    if tril:  # only the lower triangle is defined
        Kt, Kj = np.tril(Kt), np.tril(Kj)
    np.testing.assert_allclose(Kt, Kj, rtol=0, atol=_tol(form, Kj))


def test_diag_lands_on_the_global_diagonal(rng):
    X = torch.tensor(rng.standard_normal((70, 3)), dtype=torch.float32)
    K0 = gop.gram(X, X, 1.3, 1.1, form="sqdist")
    K1 = gop.gram(X, X, 1.3, 1.1, diag=0.5, form="sqdist")
    np.testing.assert_array_equal((K1 - K0).numpy(), 0.5 * np.eye(70, dtype=np.float32))
