"""Dense GP (log-)marginal likelihoods with gradients.

Mirrors gpr_tpu/gp/likelihood.py (whole file), the reference's likelihood
hierarchy (include/Likelihood.h:95-354).  The gradients come from autograd
through ``linalg.safe_cholesky``'s Murray pullback, with respect to the
kernel's reference-ordered ``params_vector``; the reference's hand-derived
0.5 tr((alpha alpha^T - C) dK/dtheta) forms stay in the tests as golden
checks.

Conventions (the reference's):

* ``gaussian_log_likelihood`` is a vector, one entry per output dimension:
  value_i = -0.5 y_i^T C y_i - 0.5 log|K + s^2 I| - n/2 log 2pi
  (Likelihood.h:166-202).
* ``mll_scalar`` is sum_i datafit_i + complexity (complexity counted once),
  the objective whose gradient is the reference's GetParameterDerivatives
  (Likelihood.h:204-229).
* ``mll_jacobian`` differentiates each output dimension's full value
  (GetValueAndJacobian, Likelihood.h:287-344).

K is built in the dtype of X, so a float32 X on the card factors in float32
on the routes of ``linalg.safe_cholesky`` (``fused-matrix``, ``blocked-syrk``
...) while the float64 hyperparameters get a float64 gradient.  Every entry
point takes ``device`` (utils/config.py: the card unless told otherwise);
Y is cast to X's dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels import kernels as kermod
from ..ops import linalg
from ..utils import config


def _inputs(X, Y, device=None):
    X = config.as_input(X, device)
    Y = config.as_input(Y, X.device).to(X.dtype)
    return (X[:, None] if X.ndim == 1 else X), (Y[:, None] if Y.ndim == 1 else Y)


def factor_route(X) -> str:
    """The factorization route (``linalg.cholesky_route``) of K(X, X) + s^2 I."""
    return linalg.route_for(X.shape[0], X.dtype, X.device)


def _chol_K(kernel, X, sigma, jitter=0.0):
    K = kermod.gram(kernel, X)
    K = linalg.add_diagonal(K, torch.as_tensor(sigma, dtype=K.dtype) ** 2)
    L, _ = linalg.safe_cholesky(K, initial_jitter=jitter)
    return L


def _terms(kernel, X, Y, sigma):
    """(datafit per output (q,), complexity, constant) from one factorization."""
    n = X.shape[0]
    L = _chol_K(kernel, X, sigma)
    alpha = linalg.cho_solve(L, Y)
    df = -0.5 * (Y * alpha).sum(0)
    cp = -0.5 * linalg.logdet_from_chol(L)
    return df, cp, -n / 2.0 * math.log(2 * math.pi)


def gaussian_log_likelihood(kernel, X, Y, sigma, device=None) -> torch.Tensor:
    """Per-output-dimension log marginal likelihood vector (q,)
    (reference GaussianLogLikelihood::operator(), Likelihood.h:166-202)."""
    X, Y = _inputs(X, Y, device)
    df, cp, ct = _terms(kernel, X, Y, sigma)
    return df + cp + ct


def gaussian_likelihood(kernel, X, Y, sigma, device=None) -> torch.Tensor:
    """Non-log Gaussian likelihood (reference GaussianLikelihood,
    Likelihood.h:95-150): exp(datafit) / sqrt(det) / (2 pi)^(n/2)."""
    X, Y = _inputs(X, Y, device)
    df, cp, _ = _terms(kernel, X, Y, sigma)
    return torch.exp(df) * torch.exp(cp) * (2 * math.pi) ** (-X.shape[0] / 2.0)


def mll_scalar(kernel, X, Y, sigma, device=None) -> torch.Tensor:
    """Scalar objective whose gradient matches the reference's
    ``GetParameterDerivatives`` (Likelihood.h:204-229):
    sum_i datafit_i - 0.5 log|K| - n/2 log 2pi.  Differentiable in the
    kernel's hyperparameters when they carry a graph."""
    X, Y = _inputs(X, Y, device)
    df, cp, ct = _terms(kernel, X, Y, sigma)
    return df.sum() + cp + ct


def _attached(kernel):
    vec = kermod.params_vector(kernel).detach().requires_grad_()
    return vec, kernel.with_params(list(vec))


def mll_value_and_grad(kernel, X, Y, sigma, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value vector (q,), gradient (p,)): the reference's
    ``GetValueAndParameterDerivatives`` (Likelihood.h:231-285).  The value
    is the per-dimension vector, the gradient that of :func:`mll_scalar`;
    one Gram and one factorization serve both (likelihood.py:105-135)."""
    X, Y = _inputs(X, Y, device)
    with torch.enable_grad():
        vec, k = _attached(kernel)
        df, cp, ct = _terms(k, X, Y, sigma)
        (grad,) = torch.autograd.grad(df.sum() + cp + ct, vec, materialize_grads=True)
    return (df + cp + ct).detach(), grad


def mll_jacobian(kernel, X, Y, sigma, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value vector (q,), jacobian (q, p)): reference ``GetValueAndJacobian``
    (Likelihood.h:287-344); row i differentiates datafit_i + complexity.
    One forward pass, q backward passes over its graph."""
    X, Y = _inputs(X, Y, device)
    with torch.enable_grad():
        vec, k = _attached(kernel)
        df, cp, ct = _terms(k, X, Y, sigma)
        value = df + cp + ct
        q = value.shape[0]
        J = torch.stack([
            torch.autograd.grad(value[i], vec, retain_graph=i + 1 < q, materialize_grads=True)[0]
            for i in range(q)
        ])
    return value.detach(), J
