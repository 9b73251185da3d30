"""Sparse (inducing-point) GP regression: the projected-process / SoR model.

Mirrors gpr_tpu/gp/sparse.py:47-87 (``SparseGP``), 109-158 (``fit_sparse``),
165-261 (the Woodbury pieces, the likelihood, its value and gradients),
264-291 (``optimize_inducing``), 299-375 (``titsias_elbo``, ``fit_svgp``) and
385-422 (``save_sparse``, ``load_sparse``): the reference's
``gpr::SparseGaussianProcess`` (include/SparseGaussianProcess.h:30-416) and
``SparseGaussianLogLikelihood`` (include/SparseLikelihood.h:112-551).

  training     Kmm = k(Z, Z) + jitter I,  Knm = k(X, Z),
               Sigma = (Kmm + s^-2 Kmn Knm)^-1,
               alpha = s^-2 Sigma Kmn Y,  R = Sigma
               (the reference's cancelling Kmm inv(Kmm) pairs dropped,
               SparseGaussianProcess.h:274-313)
  prediction   mean(x) = Kx^T alpha,
               cov(x, y) = k(x, y) - Kx^T Kmm^-1 Ky + Kx^T R Ky
  likelihood   C = s^2 I + Knm Kmm^-1 Kmn through the Woodbury identity and
               the determinant lemma, O(n m^2) (SparseLikelihood.h:129-217)

Both m x m factors go through ``linalg.safe_cholesky``, so they take the
exact GP's factorization routes (``linalg.cholesky_route``):
``torch-cholesky`` below m = 1024, ``fused-matrix`` (K2-K4) for a CUDA
float32 matrix with m >= 1024 and m % 128 == 0, the blocked routes
otherwise.  ``SparseGP.route`` records the route of Kmm's factor.  The
gradients, with respect to the hyperparameters and the inducing locations,
come from autograd through ``safe_cholesky``'s Murray pullback.

``optimize_inducing`` and ``fit_svgp`` run ``torch.optim.Adam`` with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8), the rule of ``optax.adam(lr)``; their
trace holds the objective at the parameters each step started from, as
JAX's ``lax.scan`` returns it.  The entry points take the dtype of their
inputs (Z and Y are cast to X's) and run on the card unless given
``device="cpu"`` or CPU tensors (utils/config.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..kernels import kernels as kermod
from ..kernels.dsl import kernel_to_string, parse_kernel
from ..ops import linalg
from ..utils import config


class SparseGP(nn.Module):
    """A trained sparse GP.

    Buffers:
      Z      (m, d) inducing inputs (the reference's m_InducingSampleVectors)
      X, Y   (n, d), (n, q) dense inputs and labels
      sigma, jitter  0-dim
      alpha  (m, q) mean regression weights
      R      (m, m) variance regression matrix
      Lmm    (m, m) chol(Kmm + jitter I)
    """

    def __init__(self, kernel, Z, X, Y, sigma, jitter, alpha, R, Lmm, route=None):
        super().__init__()
        self.kernel = kernel
        for name, value in (("Z", Z), ("X", X), ("Y", Y), ("alpha", alpha), ("R", R), ("Lmm", Lmm)):
            self.register_buffer(name, value)
        for name, value in (("sigma", sigma), ("jitter", jitter)):
            self.register_buffer(name, torch.as_tensor(value, dtype=X.dtype, device=X.device))
        self.route = route

    def _point(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.Z.dtype, device=self.Z.device)

    def predict(self, Xs) -> torch.Tensor:
        """Posterior mean: a point (d,) -> (q,), a batch (t, d) -> (t, q)."""
        Xs = self._point(Xs)
        mean = kermod.gram(self.kernel, torch.atleast_2d(Xs), self.Z) @ self.alpha
        return mean[0] if Xs.ndim <= 1 else mean

    def posterior_cov(self, x, y) -> torch.Tensor:
        """cov(x, y) = k(x, y) - Kx^T Kmm^-1 Ky + Kx^T R Ky
        (reference SparseGaussianProcess.h:94-106)."""
        x, y = torch.atleast_1d(self._point(x)), torch.atleast_1d(self._point(y))
        Kx = kermod.kvec(self.kernel, self.Z, x)
        Ky = kermod.kvec(self.kernel, self.Z, y)
        return self.kernel(x, y) - Kx @ linalg.cho_solve(self.Lmm, Ky) + Kx @ (self.R @ Ky)

    def credible_interval(self, x) -> torch.Tensor:
        c = self.posterior_cov(x, x)
        return 2.0 * torch.sqrt(torch.clamp(c, min=0.0))

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]


def _inputs(Z, X, Y=None, device=None):
    X = torch.atleast_2d(config.as_input(X, device))
    Z = torch.atleast_2d(config.as_input(Z, X.device)).to(X.dtype)
    if Y is None:
        return Z, X
    Y = config.as_input(Y, X.device).to(X.dtype)
    return Z, X, (Y[:, None] if Y.ndim == 1 else Y)


def _noise_var(sigma, X) -> torch.Tensor:
    # sigma^2 in X's dtype; a sigma that carries a graph keeps it
    return torch.as_tensor(sigma, dtype=X.dtype, device=X.device) ** 2


def fit_sparse(kernel, Z, X, Y, sigma: float, jitter: float = 0.0, device=None) -> SparseGP:
    """Train the sparse GP (reference PreComputeRegression,
    SparseGaussianProcess.h:274-313) by two Cholesky factorizations."""
    Z, X, Y = _inputs(Z, X, Y, device)
    if Z.shape[0] > X.shape[0]:
        raise ValueError(
            "SparseGaussianProcess::ComputeKernelVectorMatrix: number of dense "
            "samples must be higher than the number of sparse samples"
        )
    Kmm = linalg.add_diagonal(kermod.gram(kernel, Z), jitter)
    route = linalg.cholesky_route(Kmm)
    Lmm, _ = linalg.safe_cholesky(Kmm)
    Knm = kermod.gram(kernel, X, Z)  # (n, m)
    inv_s2 = 1.0 / _noise_var(sigma, X)
    # Sigma = inv(Kmm + s^-2 Kmn Knm); alpha = s^-2 Sigma Kmn Y; R = Sigma
    Ls, _ = linalg.safe_cholesky(Kmm + inv_s2 * (Knm.T @ Knm))
    alpha = inv_s2 * linalg.cho_solve(Ls, Knm.T @ Y)
    R = linalg.cho_solve(Ls, torch.eye(Z.shape[0], dtype=X.dtype, device=X.device))
    return SparseGP(kernel, Z, X, Y, sigma, jitter, alpha, R, Lmm, route=route)


# ---------------------------------------------------------------------------
# Woodbury marginal likelihood
# ---------------------------------------------------------------------------

def _woodbury_pieces(kernel, Z, X, sigma, jitter):
    """(Lmm, Knm, Linner, s2, logdet_C, n, m) for C = s^2 I + Knm Kmm^-1 Kmn
    with inner = Kmm + s^-2 Kmn Knm (sparse.py:165-193):

      C^-1 b = s^-2 (b - Knm inner^-1 (Kmn b) s^-2)
      log|C| = n log s^2 + log|inner| - log|Kmm|

    (the reference's EfficientInversion / EfficientDeterminant,
    SparseLikelihood.h:129-150, in log space)."""
    n, m = X.shape[0], Z.shape[0]
    s2 = _noise_var(sigma, X)
    Kmm = linalg.add_diagonal(kermod.gram(kernel, Z), jitter)
    Lmm, _ = linalg.safe_cholesky(Kmm)
    Knm = kermod.gram(kernel, X, Z)
    Linner, _ = linalg.safe_cholesky(Kmm + (Knm.T @ Knm) / s2)
    logdet_C = n * torch.log(s2) + linalg.logdet_from_chol(Linner) - linalg.logdet_from_chol(Lmm)
    return Lmm, Knm, Linner, s2, logdet_C, n, m


def woodbury_solve(Knm, Linner, s2, B):
    """C^-1 B with C = s^2 I + Knm Kmm^-1 Kmn, inner factored as Linner
    (sparse.py:196-205)."""
    u = linalg.cho_solve(Linner, (Knm.T @ B) / s2)
    return (B - Knm @ u) / s2


def _terms(kernel, Z, X, Y, sigma, jitter):
    """(datafit per output (q,), complexity, constant) from one set of pieces."""
    Lmm, Knm, Linner, s2, logdet_C, n, m = _woodbury_pieces(kernel, Z, X, sigma, jitter)
    df = -0.5 * (Y * woodbury_solve(Knm, Linner, s2, Y)).sum(0)
    return df, -0.5 * logdet_C, -n / 2.0 * math.log(2 * math.pi)


def sparse_log_likelihood(kernel, Z, X, Y, sigma, jitter: float = 0.0, device=None) -> torch.Tensor:
    """Per-output-dimension log marginal likelihood (q,) of the sparse model
    (reference SparseGaussianLogLikelihood::operator(), SparseLikelihood.h:
    152-217): -0.5 y_i^T C^-1 y_i - 0.5 log|C| - n/2 log 2pi."""
    df, cp, ct = _terms(kernel, *_inputs(Z, X, Y, device), sigma, jitter)
    return df + cp + ct


def sparse_mll_scalar(kernel, Z, X, Y, sigma, jitter: float = 0.0, device=None) -> torch.Tensor:
    """The scalar objective: the datafit summed over the outputs, the
    complexity once (sparse.py:229-243, the sparse analogue of
    SparseLikelihood.h:287-409)."""
    df, cp, ct = _terms(kernel, *_inputs(Z, X, Y, device), sigma, jitter)
    return df.sum() + cp + ct


def sparse_mll_value_and_grad(kernel, Z, X, Y, sigma, jitter: float = 0.0, device=None):
    """(value vector (q,), gradient of :func:`sparse_mll_scalar` with respect
    to the reference-ordered hyperparameters (p,)) (sparse.py:246-251);
    one set of pieces serves both."""
    Z, X, Y = _inputs(Z, X, Y, device)
    with torch.enable_grad():
        vec = kermod.params_vector(kernel).detach().requires_grad_()
        df, cp, ct = _terms(kernel.with_params(list(vec)), Z, X, Y, sigma, jitter)
        (grad,) = torch.autograd.grad(df.sum() + cp + ct, vec, materialize_grads=True)
    return (df + cp + ct).detach(), grad


def sparse_mll_and_grad_inducing(kernel, Z, X, Y, sigma, jitter: float = 0.0, device=None):
    """(value, gradient with respect to the inducing locations (m, d))
    (sparse.py:254-261): Z enters Kmm and Knm."""
    Z, X, Y = _inputs(Z, X, Y, device)
    with torch.enable_grad():
        z = Z.detach().requires_grad_()
        df, cp, ct = _terms(kernel, z, X, Y, sigma, jitter)
        val = df.sum() + cp + ct
        (grad,) = torch.autograd.grad(val, z)
    return val.detach(), grad


def _ascend(objective, params, learning_rate: float, iterations: int, like: torch.Tensor):
    """Adam ascent of ``objective()`` over ``params``; the trace (on the
    device of ``like``) holds the objective at each step's start."""
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    trace = torch.empty(iterations, dtype=like.dtype, device=like.device)
    for i in range(iterations):
        with torch.enable_grad():
            val = objective()
            grads = torch.autograd.grad(-val, params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        trace[i] = val.detach()
    return trace


def optimize_inducing(kernel, Z0, X, Y, sigma, jitter: float = 0.0, iterations: int = 100,
                      learning_rate: float = 0.01, device=None):
    """Adam ascent of :func:`sparse_mll_scalar` over the inducing locations
    (sparse.py:264-291); returns (Z, trace (iterations,))."""
    Z0, X, Y = _inputs(Z0, X, Y, device)
    z = Z0.detach().clone().requires_grad_()
    trace = _ascend(lambda: sparse_mll_scalar(kernel, z, X, Y, sigma, jitter), [z], learning_rate,
                    iterations, X)
    return z.detach(), trace


# ---------------------------------------------------------------------------
# Titsias variational bound (SVGP)
# ---------------------------------------------------------------------------

def titsias_elbo(kernel, Z, X, Y, sigma, jitter: float = 0.0, device=None) -> torch.Tensor:
    """The collapsed variational bound (Titsias 2009; sparse.py:299-329)

        ELBO = log N(y | 0, s^2 I + Q_nn) - tr(K_nn - Q_nn) / (2 s^2),

    :func:`sparse_mll_scalar` less the variance the inducing points leave
    unexplained.  diag(Q_nn) = column sums of V * V, V = Lmm^-1 Kmn;
    diag(K_nn) is the kernel on row-wise pairs, never the n x n Gram."""
    Z, X, Y = _inputs(Z, X, Y, device)
    Lmm, Knm, Linner, s2, logdet_C, n, m = _woodbury_pieces(kernel, Z, X, sigma, jitter)
    df = -0.5 * (Y * woodbury_solve(Knm, Linner, s2, Y)).sum()
    base = df - 0.5 * logdet_C - n / 2.0 * math.log(2 * math.pi)
    V = torch.linalg.solve_triangular(Lmm, Knm.T, upper=False)  # (m, n)
    q_diag = (V * V).sum(0)
    k_diag = kernel(X, X)
    return base - (k_diag - q_diag).sum() / (2.0 * s2)


def fit_svgp(kernel, Z0, X, Y, sigma, jitter: float = 0.0, iterations: int = 200,
             learning_rate: float = 0.01, optimize_hyperparameters: bool = True, device=None):
    """Adam ascent of :func:`titsias_elbo` over the inducing locations and,
    with ``optimize_hyperparameters``, the log-hyperparameters
    (sparse.py:332-375); returns (the trained SparseGP, the ELBO trace).
    Without it the kernel stays as given: JAX zeroes the hyperparameters'
    gradient, and Adam then leaves them where they are."""
    Z0, X, Y = _inputs(Z0, X, Y, device)
    z = Z0.detach().clone().requires_grad_()
    log_theta = torch.log(kermod.params_vector(kernel)).detach().requires_grad_()

    def current():
        return kernel.with_params(list(torch.exp(log_theta))) if optimize_hyperparameters else kernel

    params = [z, log_theta] if optimize_hyperparameters else [z]
    trace = _ascend(lambda: titsias_elbo(current(), z, X, Y, sigma, jitter), params, learning_rate,
                    iterations, X)
    with torch.no_grad():
        return fit_sparse(current(), z.detach(), X, Y, sigma, jitter), trace


# ---------------------------------------------------------------------------
# persistence: one npz file, read and written by both packages
# ---------------------------------------------------------------------------

_ARRAYS = ("Z", "X", "Y", "sigma", "jitter", "alpha", "R", "Lmm")


def save_sparse(sgp: SparseGP, path: str) -> None:
    """The arrays and the kernel in the kernel-string DSL, as one npz
    (sparse.py:385-403)."""
    np.savez(path, kernel_string=np.array(kernel_to_string(sgp.kernel)),
             **{k: getattr(sgp, k).detach().cpu().numpy() for k in _ARRAYS})


def load_sparse(path: str, dtype=None, device=None) -> SparseGP:
    """Load a file written by :func:`save_sparse` or by the JAX package
    (sparse.py:406-422), its arrays cast to the numpy ``dtype`` when given,
    on ``device`` (by default the card, utils/config.py)."""
    device = config.resolve_device(device)
    with np.load(path) as z:
        kernel = parse_kernel(str(z["kernel_string"]))
        arrays = {k: torch.as_tensor(z[k] if dtype is None else z[k].astype(dtype), device=device)
                  for k in _ARRAYS}
    return SparseGP(kernel, route="loaded", **arrays)
