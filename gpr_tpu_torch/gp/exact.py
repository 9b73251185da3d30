"""Exact multivariate GP regression.

Mirrors gpr_tpu/gp/exact.py:41-451 (``GP`` and ``fit``) and 454-499
(``load``).  ``GP`` is an ``nn.Module`` whose training state (X, Y, sigma,
alpha, L, core) are registered buffers and whose kernel is a submodule, so
``gp.to(device)`` moves a model.  All solves go through the Cholesky factor;
the explicit inverse exists only as the reference's CoreMatrix artifact.

``fit`` takes the JAX package's dispatch ladder (exact.py:347-451), keyed on
the tensor's device where JAX keys on ``jax.default_backend() == "tpu"``, and
records the route it took in ``GP.route``:

  ``"fused-gram"``   use_pallas_gram, a stationary form of
                     ``fullchol.GRAM_FORMS``, float32, n >= 512, CUDA: the
                     Gram-mode panel Cholesky (K2-K4, never storing K), then
                     ``cho_solve_panels``.
  ``"gram-kernel"``  use_pallas_gram otherwise (periodic, n < 512, CPU): K
                     from the Gram kernel (K1; lower triangle only at
                     n >= 1024), then ``safe_cholesky``.
  otherwise          the torch Gram, then ``safe_cholesky``, whose route
                     (``linalg.cholesky_route``) is recorded: ``"fused-matrix"``,
                     ``"blocked-syrk"``, ``"blocked"`` or ``"torch-cholesky"``.

``fit`` and ``load`` run on the card unless given ``device="cpu"`` or CPU
tensors (utils/config.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..kernels import kernels as kermod
from ..kernels.dsl import kernel_to_string, parse_kernel
from ..ops import fullchol, linalg
from ..ops import gram as gram_op
from ..utils import config, matrixio


class GP(nn.Module):
    """A trained exact GP.

    Buffers:
      X      (n, d) training inputs
      Y      (n, q) training labels
      sigma  0-dim observation noise std
      alpha  (n, q) regression vectors (K + sigma^2 I)^-1 Y
      L      (n, n) Cholesky factor of K + sigma^2 I; None in
             efficient-storage mode and for a loaded model
      core   (n, n) explicit inverse (K + sigma^2 I)^-1 of a loaded model
             (the reference's CoreMatrix), used by the covariance solves
    """

    def __init__(self, kernel: kermod.Kernel, X, Y, sigma, alpha, L=None, core=None,
                 route: Optional[str] = None):
        super().__init__()
        self.kernel = kernel
        self.register_buffer("X", X)
        self.register_buffer("Y", Y)
        self.register_buffer("sigma", torch.as_tensor(sigma, dtype=X.dtype, device=X.device))
        self.register_buffer("alpha", alpha)
        self.register_buffer("L", L)
        self.register_buffer("core", core)
        self.route = route

    # --- prediction --------------------------------------------------------
    def predict(self, Xs) -> torch.Tensor:
        """Posterior mean: one point (d,) -> (q,), or a batch (m, d) -> (m, q)
        (reference lib/GaussianProcess.cpp:53-61)."""
        Xs = torch.as_tensor(Xs, device=self.X.device)
        Xs2 = self._check_input(Xs)
        Ks = kermod.gram(self.kernel, Xs2, self.X)
        mean = Ks @ self.alpha
        return mean[0] if Xs.ndim <= 1 and Xs2.shape[0] == 1 else mean

    def posterior_cov(self, x, y) -> torch.Tensor:
        """k(x, y) - Kx^T (K + sigma^2 I)^-1 Ky (reference lib/GaussianProcess.cpp:83-99)."""
        x = torch.atleast_1d(torch.as_tensor(x, device=self.X.device))
        y = torch.atleast_1d(torch.as_tensor(y, device=self.X.device))
        Kx = kermod.kvec(self.kernel, self.X, x)
        Ky = kermod.kvec(self.kernel, self.X, y)
        return self.kernel(x, y) - Kx @ self._core_solve(Ky[:, None])[:, 0]

    def posterior_var(self, Xs) -> torch.Tensor:
        """Diagonal posterior variance at the points Xs (m, d) -> (m,)."""
        Xs2 = self._check_input(torch.as_tensor(Xs, device=self.X.device))
        Ks = kermod.gram(self.kernel, Xs2, self.X)
        kss = self.kernel._eval(Xs2, Xs2)
        solved = self._core_solve(Ks.T)
        return kss - (Ks * solved.T).sum(-1)

    def credible_interval(self, x) -> torch.Tensor:
        """2 sqrt(max(0, var)) with the reference's negative-variance clamp
        (lib/GaussianProcess.cpp:101-114)."""
        x = torch.as_tensor(x, device=self.X.device)
        x2 = self._check_input(x)
        if x.ndim <= 1 and x2.shape[0] == 1:
            var = self.posterior_cov(x2[0], x2[0])
        else:
            var = self.posterior_var(x2)
        return 2.0 * torch.sqrt(torch.clamp(var, min=0.0))

    # --- internals ----------------------------------------------------------
    def _check_input(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.atleast_1d(x)
        d = self.X.shape[1]
        if x.ndim == 1:
            if d == 1 and x.shape[0] != 1:
                return x[:, None]  # a batch of scalar inputs on a 1-d GP
            if x.shape[0] != d:
                raise ValueError(
                    f"GaussianProcess::Predict: dimension of input vector ({x.shape[0]}) "
                    f"does not correspond to the input dimension ({d})."
                )
            return x[None, :]
        if x.shape[-1] != d:
            raise ValueError(
                f"GaussianProcess::Predict: dimension of input vector ({x.shape[-1]}) "
                f"does not correspond to the input dimension ({d})."
            )
        return x

    def _require_core(self) -> torch.Tensor:
        """The Cholesky factor, recomputed when it was dropped."""
        if self.L is not None:
            return self.L
        K = linalg.add_diagonal(kermod.gram(self.kernel, self.X), self.sigma**2)
        return linalg.safe_cholesky(K)[0]

    def _core_solve(self, B: torch.Tensor) -> torch.Tensor:
        """(K + sigma^2 I)^-1 B: Cholesky solves when the factor is present,
        one product with the loaded CoreMatrix when only that is, and a
        refactorization otherwise (efficient storage)."""
        if self.L is not None:
            return linalg.cho_solve(self.L, B)
        if self.core is not None:
            return self.core.to(B.dtype) @ B
        return linalg.cho_solve(self._require_core(), B)

    def materialize(self) -> "GP":
        """A GP with the Cholesky factor restored (one factorization)."""
        if self.L is not None:
            return self
        return GP(self.kernel, self.X, self.Y, self.sigma, self.alpha, self._require_core(),
                  self.core, self.route)

    @property
    def num_samples(self) -> int:
        return self.X.shape[0]

    @property
    def input_dim(self) -> int:
        return self.X.shape[1]

    @property
    def output_dim(self) -> int:
        return self.Y.shape[1]

    # --- persistence --------------------------------------------------------
    def save(self, prefix: str) -> None:
        """Write the reference's 5-file artifact set (lib/GaussianProcess.cpp:133-180):
        -RegressionVectors (n x q), -CoreMatrix (n x n, 0 x 0 in efficient
        storage), -SampleVectors (d x n), -LabelVectors (q x n) and
        -ParameterFile (sigma, dims, flags, kernel string)."""
        def host(t):
            return t.detach().cpu().numpy()

        matrixio.write_matrix(host(self.alpha), prefix + "-RegressionVectors.txt")
        if self.L is not None:
            eye = torch.eye(self.L.shape[0], dtype=self.L.dtype, device=self.L.device)
            core = host(linalg.cho_solve(self.L, eye))
        elif self.core is not None:
            core = host(self.core)
        else:
            core = np.zeros((0, 0))
        matrixio.write_matrix(core, prefix + "-CoreMatrix.txt")
        matrixio.write_matrix(host(self.X).T, prefix + "-SampleVectors.txt")
        matrixio.write_matrix(host(self.Y).T, prefix + "-LabelVectors.txt")
        # efficient storage means no CoreMatrix was written; a loaded model
        # saved again keeps its CoreMatrix and says so (cf. exact.py:269)
        efficient = 1 if self.L is None and self.core is None else 0
        with open(prefix + "-ParameterFile.txt", "w") as f:
            f.write(f"{float(self.sigma):.17g} {self.input_dim} {self.output_dim} {efficient} 0 ")
            f.write(kernel_to_string(self.kernel))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def fit(kernel: kermod.Kernel, X, Y, sigma: float = 0.0, efficient_storage: bool = False,
        jitter: float = 0.0, use_pallas_gram: bool = False, device=None) -> GP:
    """Train an exact GP: factor K + sigma^2 I and solve for the regression
    vectors (reference Initialize -> ComputeRegressionVectors,
    lib/GaussianProcess.cpp:117-130, 641-672, through a Cholesky solve).
    ``use_pallas_gram`` (the JAX package's name) routes the stationary
    kernels through the hand-written Gram and fused-factorization kernels;
    see the module docstring for the routes.  X and Y run on ``device``
    (see utils/config.py: the card unless told otherwise)."""
    X = config.as_input(X, device)
    Y = config.as_input(Y, X.device)
    if X.ndim == 1:
        X = X[:, None]
    if Y.ndim == 1:
        Y = Y[:, None]
    if X.shape[0] == 0:
        raise ValueError("GaussianProcess::Initialize: no input samples defined during initialization")
    X = X.contiguous()
    n = X.shape[0]
    sigma = float(sigma)
    K = None
    if use_pallas_gram:
        disp = kermod.kernel_form(kernel)
        if disp is not None:
            form, *vals = disp
            sg, sc, third = (float(v) for v in vals)
            noise = float(np.float32(sigma) ** 2)  # sigma^2 in float32, as exact.py:351
            if (form in fullchol.GRAM_FORMS and X.dtype == torch.float32 and n >= 512
                    and X.device.type == "cuda"):
                L, W, _ = fullchol.safe_gram_cholesky_fused(
                    X, sg, sc, third, noise, form=form, initial_jitter=jitter, return_winv=True,
                )
                n_pad = L.shape[0]
                Yp = torch.zeros((n_pad, Y.shape[1]), dtype=Y.dtype, device=Y.device)
                Yp[:n] = Y
                # the padded system is block diagonal: its leading factor is
                # chol(K + sigma^2 I) and the pad rows of alpha are exact 0
                alpha = fullchol.cho_solve_panels(L, W, Yp)[:n]
                return GP(kernel, X, Y, sigma, alpha, None if efficient_storage else L[:n, :n],
                          route="fused-gram")
            Xf = X.to(torch.float32)
            K = gram_op.gram(Xf, Xf, sg, sc, third, diag=noise, form=form,
                             tril=n >= linalg.BLOCKED_MIN_N).to(X.dtype)
            route = "gram-kernel"
    if K is None:
        K = linalg.add_diagonal(kermod.gram(kernel, X), torch.as_tensor(sigma, dtype=X.dtype) ** 2)
        route = linalg.cholesky_route(K)
    L, _ = linalg.safe_cholesky(K, initial_jitter=jitter)
    alpha = linalg.cho_solve(L, Y)
    return GP(kernel, X, Y, sigma, alpha, None if efficient_storage else L, route=route)


def load(prefix: str, dtype=None, device=None) -> GP:
    """Load a model saved by :meth:`GP.save`, by the JAX package or by the
    reference's ``GaussianProcess::Save`` (lib/GaussianProcess.cpp:183-268).
    The stored CoreMatrix is used directly; nothing is refactored.  The model
    goes to ``device``, by default the card (utils/config.py)."""
    device = config.resolve_device(device)
    for suffix in ("-RegressionVectors.txt", "-CoreMatrix.txt", "-SampleVectors.txt",
                   "-LabelVectors.txt", "-ParameterFile.txt"):
        path = prefix + suffix
        if not os.path.exists(path) or os.path.isdir(path):
            raise FileNotFoundError(f"GaussianProcess::Load: {path} does not exist or is a directory.")

    def read(suffix):
        return torch.as_tensor(matrixio.read_matrix(prefix + suffix, dtype), device=device)

    alpha = read("-RegressionVectors.txt")
    core = read("-CoreMatrix.txt")
    X = read("-SampleVectors.txt").T.contiguous()
    Y = read("-LabelVectors.txt").T.contiguous()
    with open(prefix + "-ParameterFile.txt") as f:
        parts = f.readline().split(None, 5)
    if len(parts) < 6:
        raise ValueError("GaussianProcess::Load: parameter file is corrupt")
    kernel = parse_kernel(parts[5].strip())
    return GP(kernel, X, Y, float(parts[0]), alpha, None, core if core.numel() else None,
              route="loaded")
