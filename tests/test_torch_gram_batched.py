"""The fleet Gram's plain version (gpr_tpu_torch.ops.gram.gram_batched_reference,
kernel K6's) against the JAX package: its Pallas fleet Gram
(gpr_tpu.ops.pallas_gram.gram_pallas_batched) in interpret mode, and its
float64 kernel Grams member by member.  Also the wrapper's refusals.

float32 inputs with |x|^2 ~ 5, B=3 members with their own (sigma, scale,
third, diag).  Tolerances, as for K1 (tests/test_torch_gram.py): the Pallas
kernel's cross term runs at the bf16x3 tier (pallas_gram.py:60-81), whose
dropped lo*lo term leaves d2 off by ~1.5e-5 |x|^2, while the port runs full
float32.  Hence 3e-4 * scale^2 for the smooth forms, 5e-3 * scale^2 for
matern12 (its r = sqrt(d2) cusp turns a d2 error e near the diagonal into
sqrt(e)), 1e-5 of the largest entry for sqdist.  Against the float64 Grams
(the JAX fleet's own Gram off the TPU, batched.py:171-176) the port's
float32 rounding alone remains: 1e-5 * scale^2 for the smooth forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_tpu as jg
from gpr_tpu.ops.pallas_gram import gram_pallas_batched
from gpr_tpu_torch.ops import _cuda
from gpr_tpu_torch.ops import gram as gop

B, N, D = 3, 40, 5
# rows: member; columns: sigma, scale, third (rq alpha / periodic b), diag
PARAMS = np.array([[1.3, 1.1, 2.0, 0.37],
                   [1.7, 0.8, 0.7, 0.1],
                   [2.1, 1.4, 1.5, 0.05]], np.float32)


def _inputs(seed=0):
    X = np.random.default_rng(seed).standard_normal((B, N, D)).astype(np.float32)
    return X, torch.tensor(X), torch.tensor(PARAMS)


def _scale2():
    return float(PARAMS[:, 1].max()) ** 2


@pytest.mark.parametrize("form", gop.FORMS)
def test_matches_pallas_interpret(form):
    X, Xt, Pt = _inputs()
    Kj = np.asarray(gram_pallas_batched(jnp.asarray(X), *(PARAMS[:, i] for i in range(4)),
                                        form=form, interpret=True))
    _cuda.reset_launch_counts()
    Kt = gop.gram_batched(Xt, Pt, form=form).numpy()
    assert _cuda.launch_counts()["gram_batched"] == 0  # a CPU tensor runs the plain version
    assert Kt.dtype == np.float32 and Kt.shape == (B, N, N)
    if form == "sqdist":
        tol = 1e-5 * np.abs(Kj).max()
    else:
        tol = (5e-3 if form == "matern12" else 3e-4) * _scale2()
    np.testing.assert_allclose(Kt, Kj, rtol=0, atol=tol)


def _jax_kernel(form, sigma, scale, third):
    return {"gaussian": lambda: jg.Gaussian(sigma, scale),
            "rq": lambda: jg.RationalQuadratic(scale, sigma, third),
            "matern12": lambda: jg.Matern12(sigma, scale),
            "matern32": lambda: jg.Matern32(sigma, scale),
            "matern52": lambda: jg.Matern52(sigma, scale),
            "periodic": lambda: jg.Periodic(scale, third, sigma)}[form]()


@pytest.mark.parametrize("form", [f for f in gop.FORMS if f != "sqdist"])
def test_matches_float64_kernel_grams(form):
    X, Xt, Pt = _inputs(1)
    Kt = gop.gram_batched_reference(Xt, Pt, form=form).numpy()
    for b in range(B):
        sigma, scale, third, diag = (float(v) for v in PARAMS[b])
        k = _jax_kernel(form, sigma, scale, third)
        Kj = np.asarray(jg.gram(k, jnp.asarray(X[b], jnp.float64))) + diag * np.eye(N)
        tol = (5e-3 if form == "matern12" else 1e-5) * scale**2
        np.testing.assert_allclose(Kt[b], Kj, rtol=0, atol=tol)


def test_members_match_the_single_gram():
    """Member b of the fleet Gram is K1's plain Gram of X[b] with row b's
    parameters, to the last bit of the shared torch expression."""
    _, Xt, Pt = _inputs(2)
    for form in ("gaussian", "periodic"):
        K = gop.gram_batched_reference(Xt, Pt, form=form)
        for b in range(B):
            sg, sc, th, dg = (float(v) for v in PARAMS[b])
            Kb = gop.gram_reference(Xt[b], Xt[b], sg, sc, th, dg, form=form)
            torch.testing.assert_close(K[b], Kb, rtol=1e-6, atol=1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    X, P = torch.zeros((2, 10, 3)), torch.ones((2, 4))
    with pytest.raises(ValueError):
        gop.gram_batched(X.double(), P)  # dtype
    with pytest.raises(ValueError):
        gop.gram_batched(X, torch.ones((3, 4)))  # one row of parameters per member
    with pytest.raises(ValueError):
        gop.gram_batched(X[0], P)  # not (B, n, d)
    with pytest.raises(ValueError):
        gop.gram_batched(X.transpose(1, 2), P)  # not contiguous
    with pytest.raises(ValueError):
        gop.gram_batched(X, P, form="linear")
    with pytest.raises(ValueError):
        gop.gram_batched(torch.zeros((2, 0, 3)), P)  # empty
    with pytest.raises(ValueError):
        gop.gram_batched(X.to("meta"), P.to("meta"))  # neither CPU nor CUDA
