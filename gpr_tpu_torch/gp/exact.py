"""Exact multivariate GP regression.

Mirrors gpr_tpu/gp/exact.py:41-451 (``GP`` and ``fit``), 454-499 (``load``),
502-530 (``loo_cv``), 533-579 (``extend``) and 582-635 (``_cholupdate``,
``shrink``).  ``GP`` is an ``nn.Module`` whose training state (X, Y, sigma,
alpha, L, core) are registered buffers and whose kernel is a submodule, so
``gp.to(device)`` moves a model.  All solves go through the Cholesky factor;
the explicit inverse exists only as the reference's CoreMatrix artifact.

``fit`` takes the JAX package's dispatch ladder (exact.py:347-451), keyed on
the tensor's device where JAX keys on ``jax.default_backend() == "tpu"``, and
records the route it took in ``GP.route``:

  ``"fused-gram"``   use_pallas_gram True or None (the default), a
                     stationary form of ``fullchol.GRAM_FORMS``, float32,
                     n >= 512, CUDA: the Gram-mode panel Cholesky (K2-K4,
                     never storing K, any n by pad masking), then
                     ``cho_solve_panels``.
  ``"gram-kernel"``  use_pallas_gram True otherwise (periodic, n < 512, CPU):
                     K from the Gram kernel (K1; lower triangle only at
                     n >= 1024), then ``safe_cholesky``.
  otherwise          the torch Gram, then ``safe_cholesky``, whose route
                     (``linalg.cholesky_route``) is recorded: ``"fused-matrix"``,
                     ``"blocked-syrk"``, ``"blocked"``, their ``-leaf`` forms
                     under ``GPR_CHOL_LEAF_INV=1``, ``"inplace"`` under
                     ``GPR_CHOL_SCHEDULE=inplace``, or ``"torch-cholesky"``.

JAX's ``fit`` leaves its Gram kernel off unless asked; on its TPU a float32
fit then takes the fused factorization at any n.  The port's fused
factorization of a matrix needs n % 128 == 0, so its default (None) takes
``"fused-gram"`` wherever that route applies and the matrix ladder
elsewhere; ``use_pallas_gram=False`` keeps the matrix ladder everywhere, as
JAX's default.  On the CPU and in float64 the three agree with JAX.

``fit_route`` names the route without fitting.  The switches are read at
call time, as JAX reads them at trace time: ``GPR_FIT_SCHEDULE=twopass`` or
``GPR_CHOL_SCHEDULE`` other than ``fused`` turn ``"fused-gram"`` into
``"gram-kernel"`` (exact.py:386-393); the factorization routes follow
``linalg.route_for`` (``safe_cholesky`` on the Gram matrix, and in
``extend`` / ``shrink`` on the matrices they refactor).  Every ``linalg.cho_solve`` here (alpha, the covariance
solves, ``extend``, ``shrink``) takes the narrow solve under
``GPR_SOLVE_SCHEDULE=narrow`` where it applies (``linalg.solve_route``).

``extend`` and ``shrink`` maintain a sliding window (apps/drift.py): add the
newest samples by one block row of the factor, drop the oldest by a rank-k
Cholesky update of the trailing factor (refactored on the factor routes,
where JAX sweeps the columns).  ``loo_cv`` scores every held-out
sample from one factor.

``fit`` and ``load`` run on the card unless given ``device="cpu"`` or CPU
tensors (utils/config.py).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels import kernels as kermod
from ..kernels.dsl import kernel_to_string, parse_kernel
from ..ops import fullchol, linalg
from ..ops import gram as gram_op
from ..utils import config, matrixio
from ..utils.profiling import host_wait, span


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
        if not (isinstance(sigma, torch.Tensor) and sigma.device == X.device):
            host_wait("exact.sigma", X)  # a blocking copy to the card
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

    def predict_derivative(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, D) with D[i, j] = d mean_j / d x_i, the exact Jacobian of the
        posterior mean by forward-mode autodiff (exact.py:84-93; the reference's
        formula, lib/GaussianProcess.cpp:63-81, holds for unit-sigma Gaussian
        kernels only)."""
        x = torch.atleast_1d(torch.as_tensor(x, device=self.X.device))
        mean = self.predict(x)
        J = torch.func.jacfwd(self.predict)(x)  # (q, d)
        return mean, J.T

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

    def _posterior_factor(self, Xs, jitter: float = 1e-10) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean (m, q), Lc (m, m)): the posterior mean at Xs and the Cholesky
        factor of the symmetrized posterior covariance, with jitter escalation
        from ``jitter`` (exact.py:128-134)."""
        Xs2 = self._check_input(torch.as_tensor(Xs, device=self.X.device))
        mean = self.predict(Xs2)
        Ks = kermod.gram(self.kernel, Xs2, self.X)
        cov = kermod.gram(self.kernel, Xs2) - Ks @ self._core_solve(Ks.T)
        Lc, _ = linalg.safe_cholesky(0.5 * (cov + cov.T), initial_jitter=jitter)
        return mean, Lc

    def sample_posterior(self, generator: torch.Generator, Xs, num_samples: int = 1,
                         jitter: float = 1e-10) -> torch.Tensor:
        """Functions drawn from the posterior at Xs, (num_samples, m, q):
        mean + Lc eps with eps standard normal from ``generator``
        (exact.py:124-136, the capability of the reference's
        tests/PosteriorProcessTest.cpp:97-165).  ``generator`` lives on the
        model's device; its stream is torch's, not JAX's."""
        mean, Lc = self._posterior_factor(Xs, jitter)
        eps = torch.randn((num_samples, *mean.shape), generator=generator, dtype=mean.dtype,
                          device=mean.device)
        return mean[None] + torch.einsum("ij,sjq->siq", Lc, eps)

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

    # --- diagnostics --------------------------------------------------------
    def describe(self) -> str:
        """The reference's ``ToString`` summary (lib/GaussianProcess.cpp:268-288),
        returned instead of printed (exact.py:201-219)."""
        bar = "---------------------------------------"
        return "\n".join([
            bar,
            "Gaussian Process",
            f" - initialized:\t\t{self.alpha is not None}",
            f" - # samples:\t\t{self.num_samples}",
            f" - # labels:\t\t{self.Y.shape[0]}",
            f" - noise:\t\t{float(self.sigma)}",
            f" - input dimension:\t{self.input_dim}",
            f" - output dimension:\t{self.output_dim}",
            "",
            " - Kernel:",
            f"       - Type:\t\t{kernel_to_string(self.kernel)}",
            bar,
        ])

    def inversion_error(self) -> torch.Tensor:
        """Frobenius norm of (K + sigma^2 I) C - I with C = (L L^T)^-1, the
        reference's debug-mode inversion check (lib/GaussianProcess.cpp:
        507-509; exact.py:221-231).  O(n^3), diagnostics only."""
        K = linalg.add_diagonal(kermod.gram(self.kernel, self.X), self.sigma.to(self.X.dtype) ** 2)
        eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
        return torch.linalg.norm(K @ self._core_solve(eye) - eye)

    def __eq__(self, other) -> bool:
        """Deep comparison of alpha, X, Y, the kernel and sigma (reference
        lib/GaussianProcess.cpp:291-360; exact.py:277-297)."""
        if not isinstance(other, GP):
            return NotImplemented

        def same(a, b):
            if a is None or b is None:
                return a is None and b is None
            return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))

        return (same(self.alpha, other.alpha) and same(self.X, other.X)
                and same(self.Y, other.Y) and _same_kernel(self.kernel, other.kernel)
                and float(self.sigma) == float(other.sigma))

    def __hash__(self) -> int:
        # identity, as exact.py:299-300: nn.Module must stay hashable
        # (named_modules collects modules in a set)
        return id(self)

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

def fit_route(kernel: kermod.Kernel, n: int, dtype: torch.dtype, device,
              use_pallas_gram: Optional[bool] = None) -> str:
    """The route :func:`fit` takes for n samples of this dtype on this device
    (exact.py:347-443), with the switches read now."""
    device = torch.device(device)
    if use_pallas_gram is not False:
        disp = kermod.kernel_form(kernel)
        if disp is not None:
            if (disp[0] in fullchol.GRAM_FORMS and dtype == torch.float32 and n >= 512
                    and device.type == "cuda" and linalg._chol_schedule() == "fused"
                    and os.environ.get("GPR_FIT_SCHEDULE", "fused") == "fused"):
                return "fused-gram"
            if use_pallas_gram:
                return "gram-kernel"
    return linalg.route_for(n, dtype, device)


def fit(kernel: kermod.Kernel, X, Y, sigma: float = 0.0, efficient_storage: bool = False,
        jitter: float = 0.0, use_pallas_gram: Optional[bool] = None, device=None) -> GP:
    """Train an exact GP: factor K + sigma^2 I and solve for the regression
    vectors (reference Initialize -> ComputeRegressionVectors,
    lib/GaussianProcess.cpp:117-130, 641-672, through a Cholesky solve).
    ``use_pallas_gram`` (the JAX package's name) True routes the stationary
    kernels through the hand-written Gram and fused-factorization kernels,
    False never, None (the default) where the fused Gram route applies; see
    the module docstring for the routes.  X and Y run on ``device``
    (see utils/config.py: the card unless told otherwise).

    Spans (utils/profiling.py): ``gpr.fit`` around the call, inside it
    ``gpr.fit.factor`` (the Gram, the factor, its jitter loop and check) and
    ``gpr.fit.solve`` (the solve for alpha)."""
    with span("gpr.fit"):
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
        route = fit_route(kernel, n, X.dtype, X.device, use_pallas_gram)
        if route in ("fused-gram", "gram-kernel"):
            form, *vals = kermod.kernel_form(kernel)
            sg, sc, third = (float(v) for v in vals)
            noise = float(np.float32(sigma) ** 2)  # sigma^2 in float32, as exact.py:351
        if route == "fused-gram":
            with span("gpr.fit.factor"):
                L, W, _ = fullchol.safe_gram_cholesky_fused(
                    X, sg, sc, third, noise, form=form, initial_jitter=jitter, return_winv=True,
                )
            with span("gpr.fit.solve"):
                n_pad = L.shape[0]
                Yp = torch.zeros((n_pad, Y.shape[1]), dtype=Y.dtype, device=Y.device)
                Yp[:n] = Y
                # the padded system is block diagonal: its leading factor is
                # chol(K + sigma^2 I) and the pad rows of alpha are exact 0
                alpha = fullchol.cho_solve_panels(L, W, Yp)[:n]
            return GP(kernel, X, Y, sigma, alpha, None if efficient_storage else L[:n, :n],
                      route="fused-gram")
        with span("gpr.fit.factor"):
            if route == "gram-kernel":
                Xf = X.to(torch.float32)
                K = gram_op.gram(Xf, Xf, sg, sc, third, diag=noise, form=form,
                                 tril=n >= linalg.BLOCKED_MIN_N).to(X.dtype)
            else:
                K = linalg.add_diagonal(kermod.gram(kernel, X),
                                        torch.as_tensor(sigma, dtype=X.dtype) ** 2)
            L, _ = linalg.safe_cholesky(K, initial_jitter=jitter)
        with span("gpr.fit.solve"):
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


def _same_kernel(a: kermod.Kernel, b: kermod.Kernel) -> bool:
    """The JAX kernels' equality (kernels.py:138-147): one class and the same
    hyperparameters within 10 float64 eps."""
    if type(a) is not type(b):
        return False
    pa = [float(p) for p in a.params]
    pb = [float(p) for p in b.params]
    return len(pa) == len(pb) and bool(np.allclose(pa, pb, rtol=0, atol=10 * np.finfo(np.float64).eps))


# ---------------------------------------------------------------------------
# the sliding window: leave-one-out, extend, shrink
# ---------------------------------------------------------------------------

def _factor_of(gp: GP, name: str) -> torch.Tensor:
    if gp.L is None:
        raise ValueError(f"{name}: efficient-storage GP has no factor; call gp.materialize() first")
    return gp.L


def loo_cv(gp: GP):
    """Exact leave-one-out cross-validation from one factor (exact.py:502-530):
    with A = K + sigma^2 I and alpha = A^-1 Y (Rasmussen & Williams 5.10-5.12)

        loo_mean_i = y_i - alpha_i / (A^-1)_ii,   loo_var_i = 1 / (A^-1)_ii.

    diag(A^-1) = column sums of (L^-1)^2, one triangular solve.  Returns
    (loo_mean (n, q), loo_var (n,), log predictive density)."""
    L = gp._require_core()
    Linv = linalg._tri_solve(L, torch.eye(L.shape[0], dtype=L.dtype, device=L.device))
    diag = (Linv * Linv).sum(0)
    loo_mean = gp.Y - gp.alpha / diag[:, None]
    loo_var = 1.0 / diag
    resid = gp.Y - loo_mean
    lpd = (-0.5 * torch.log(2 * math.pi * loo_var)[:, None] - 0.5 * resid ** 2 / loo_var[:, None]).sum()
    return loo_mean, loo_var, lpd


def extend(gp: GP, Xn, Yn, jitter: float = 0.0) -> GP:
    """Add k samples in O(n^2 k) (exact.py:533-579): with L11 = chol(K11 +
    sigma^2 I) known, the factor grows by one block row,

        B = (L11^-1 K12)^T,   C = chol(K22 + (sigma^2 + jitter) I - B B^T),

    and alpha is solved again against the grown factor.  Equal to ``fit`` on
    the joined data up to rounding."""
    L11 = _factor_of(gp, "extend")
    Xn = torch.as_tensor(Xn, dtype=gp.X.dtype, device=gp.X.device)
    Yn = torch.as_tensor(Yn, dtype=gp.Y.dtype, device=gp.Y.device)
    Xn = Xn[:, None] if Xn.ndim == 1 else Xn
    Yn = Yn[:, None] if Yn.ndim == 1 else Yn
    K12 = kermod.gram(gp.kernel, gp.X, Xn)  # (n, k)
    K22 = kermod.gram(gp.kernel, Xn)
    Bt = linalg._tri_solve(L11, K12)  # L11^-1 K12
    C, _ = linalg.safe_cholesky(linalg.add_diagonal(K22, gp.sigma.to(K22.dtype) ** 2 + jitter)
                                - Bt.T @ Bt)
    n, k = K12.shape
    L = torch.zeros((n + k, n + k), dtype=L11.dtype, device=L11.device)
    L[:n, :n] = L11
    L[n:, :n] = Bt.T
    L[n:, n:] = C
    X = torch.cat([gp.X, Xn])
    Y = torch.cat([gp.Y, Yn])
    return GP(gp.kernel, X, Y, gp.sigma, linalg.cho_solve(L, Y), L, route="extend")


def _cholupdate(L: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """chol(L L^T + V V^T) for lower-triangular L (m, m) and V (m,) or (m, k),
    what exact.py:582-608 computes by one column sweep per vector (Golub &
    Van Loan 6.5.4).  Here the sum is formed by two products and factored
    again by ``safe_cholesky``, so on the card it runs the factor routes'
    kernels (K2-K4 or K5) in a few launches; a sweep would make O(m) small
    launches and lose to a refit.  The Cholesky factor is unique, so both
    agree up to rounding."""
    V = (V[:, None] if V.ndim == 1 else V).to(L.dtype)
    L = torch.tril(L)
    return linalg.safe_cholesky(L @ L.mT + V @ V.mT)[0]


def shrink(gp: GP, k: int = 1) -> GP:
    """Drop the oldest k samples in O(n^2 k) (exact.py:611-635), the sliding
    window's companion of :func:`extend`: with the factor split at k,
    A[k:, k:] = L22 L22^T + L21 L21^T, so the new factor is one rank-k
    update of L22 by the k columns of L21.  Equal to ``fit`` on the remaining
    data up to rounding."""
    L = _factor_of(gp, "shrink")
    if not 0 < k < gp.num_samples:
        raise ValueError(f"shrink: k={k} outside (0, {gp.num_samples})")
    L = _cholupdate(L[k:, k:], L[k:, :k])
    X, Y = gp.X[k:], gp.Y[k:]
    return GP(gp.kernel, X, Y, gp.sigma, linalg.cho_solve(L, Y), L, route="shrink")
