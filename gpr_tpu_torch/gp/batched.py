"""Fleets of GPs: train, predict and score B small GPs of one shape at once.

Mirrors gpr_tpu/gp/batched.py:26-372 (``BatchedGP``,
``fit_batched``, ``_fleet_gram``, ``_factor_and_solve``,
``predict_batched``, ``variance_batched``, ``mll_batched``,
``fit_batched_sharded``, ``fit_mle_batched``).  Fleets serve per-window drift models, per-patient
models, hyperparameter grids and bootstrap ensembles.  A kernel's leaves may
carry a leading batch axis (``batched_kernel=True``), e.g.
``Gaussian(torch.full((B,), 1.2), torch.ones(B))``; every per-member
function runs under ``torch.func.vmap`` (``kernels.fleet_map``).

Routes, recorded in ``BatchedGP.route``:

  ``"fleet-crout"``     the panel sweep of ops/batched.py: the diagonal scheme
                        (``GPR_FLEET_DIAG``, default K7 crout_chol) on every
                        diagonal block, batched GEMMs for the rest,
                        differentiable through its pullback.  Taken on the
                        card for float32 with n % PANEL == 0 (JAX takes its
                        Pallas fleet factorizer on a TPU), and wherever
                        ``use_crout=True``: on CPU tensors it runs the plain
                        versions, so the CPU tests follow the route.
  ``"fleet-fused"``     where ``fleet-crout`` would be taken and n <=
                        ``ops.batched._FLEET_FUSED_MAX_N`` (``GPR_FLEET_FUSED_MAX_N``
                        at import, default 0: off, as in JAX) and n <=
                        ``ops.batched.FUSED_MAX_N``, K9's limit: K9
                        fleet_fused factors and solves every member in one
                        launch; its pullback's fleet solve launches K8 once
                        (batched.py:59-75).
  ``"torch-cholesky"``  every other case and ``use_crout=False``: batched
                        ``torch.linalg.cholesky_ex`` and ``cholesky_solve``
                        (batched.py:93-95).

``fit_batched`` builds K through K6 ``gram_batched`` for float32 and the 7
stationary forms (batched.py:150-164), through the vmapped torch Gram
otherwise; ``mll_batched`` always takes the vmapped torch Gram, which
carries the hyperparameters' gradient, as JAX takes its vmapped XLA Gram
there (batched.py:229-232).  The entry points run on the card unless given
``device="cpu"`` or CPU tensors (utils/config.py).  ``fit_batched_sharded``
(batched.py:239-305) splits the members over the ranks of a device mesh,
each rank fitting its B / D on ``fit_batched``'s route with no collective.
"""

from __future__ import annotations

import math
import os
from typing import Any, NamedTuple, Optional

import torch

from ..inference.optimize import OptResult, _run_adam
from ..kernels import kernels as kermod
from ..ops import batched as fleet_ops
from ..ops import gram as gram_op
from ..ops import linalg
from ..utils import config


class BatchedGP(NamedTuple):
    """A fleet of B independent GPs with identical shapes."""

    kernel: Any           # leaves may carry a leading B axis (batched_kernel)
    X: torch.Tensor       # (B, n, d)
    Y: torch.Tensor       # (B, n, q)
    sigma: torch.Tensor   # (B,)
    alpha: torch.Tensor   # (B, n, q)
    L: torch.Tensor       # (B, n, n)
    batched_kernel: bool = False
    route: Optional[str] = None


def _fleet_inputs(X, Y, sigma, device):
    X = config.as_input(X, device).contiguous()
    Y = config.as_input(Y, X.device).to(X.dtype)
    if Y.ndim == 2:
        Y = Y[..., None]
    sigma = torch.as_tensor(sigma, dtype=X.dtype, device=X.device).expand(X.shape[0])
    return X, Y, sigma


def _panel(n: int, panel: int) -> int:
    # the port's panel, halved until it divides n (batched.py:65-69, 84-86)
    while n % panel and panel > 16:
        panel //= 2
    return panel


def fleet_route(n: int, dtype: torch.dtype, device, use_crout: Optional[bool] = None) -> str:
    """The factorization route of a fleet of (n, n) matrices."""
    if use_crout is None:
        use_crout = fleet_ops.batched_usable(n, dtype, device)
    if not use_crout:
        return "torch-cholesky"
    # K9 takes n <= FUSED_MAX_N; above it the panel sweep serves any cap
    fused_max_n = min(fleet_ops._FLEET_FUSED_MAX_N, fleet_ops.FUSED_MAX_N)
    return "fleet-fused" if n <= fused_max_n else "fleet-crout"


def _factor_and_solve(K, Y, use_crout: Optional[bool], safe: bool = False):
    """(L, alpha, route) of a fleet K (B, n, n), Y (B, n, q)
    (batched.py:45-95).  ``use_crout`` None picks the route by
    :func:`fleet_route`; True forces a fleet kernel route, False torch's.
    ``safe`` retries failed members with jitter on the same route
    (``ops.batched.factor_solve_safe``)."""
    n = K.shape[-1]
    route = fleet_route(n, K.dtype, K.device, use_crout)
    if safe:
        panel = _panel(n, fleet_ops.FUSED_PANEL if route == "fleet-fused" else fleet_ops.PANEL)
        L, alpha, _ = fleet_ops.factor_solve_safe(K, Y, route, panel)
        return L, alpha, route
    if route == "fleet-fused":
        L, alpha = fleet_ops.factor_solve_fused_diff(K, Y, _panel(n, fleet_ops.FUSED_PANEL))
        return L, alpha, route
    if route == "fleet-crout":
        L, alpha = fleet_ops.factor_solve_batched_diff(K, Y, _panel(n, fleet_ops.PANEL))
        return L, alpha, route
    L, info = torch.linalg.cholesky_ex(K)
    # NaN where a member failed, as jnp.linalg.cholesky returns it
    L = torch.where((info != 0)[:, None, None], torch.nan, L)
    return L, torch.cholesky_solve(Y, L), route


def _fleet_gram(kernel, X, noise, batched_kernel: bool):
    """K[b] + noise[b] I for the fleet (batched.py:132-176): K6 for float32
    and the stationary forms, with the (B, 4) parameter rows built on the
    device; the vmapped torch Gram otherwise, and wherever
    ``GPR_FLEET_GRAM`` is not ``pallas`` (read at call time, batched.py:138-146)."""
    use_k6 = X.dtype == torch.float32 and os.environ.get("GPR_FLEET_GRAM", "pallas") == "pallas"
    disp = kermod.kernel_form(kernel) if use_k6 else None
    if disp is not None:
        form, *vals = disp
        B = X.shape[0]
        params = torch.stack(
            [torch.as_tensor(v).to(device=X.device, dtype=torch.float32).expand(B)
             for v in (*vals, noise)], dim=1).contiguous()
        return gram_op.gram_batched(X, params, form=form)
    return kermod.fleet_map(_noisy_gram, kernel, batched_kernel, X, noise)


def _noisy_gram(k, x, noise):
    # one member's K + noise I
    return linalg.add_diagonal(kermod.gram(k, x), noise)


def fit_batched(kernel, X, Y, sigma, jitter: float = 0.0, batched_kernel: bool = False,
                use_crout: Optional[bool] = None, device=None, safe: bool = False) -> BatchedGP:
    """Train B GPs at once: X (B, n, d), Y (B, n, q) or (B, n), sigma a
    scalar or (B,).  K + (sigma^2 + jitter) I, then the fleet factorization
    and solve (batched.py:98-129); the route is in ``BatchedGP.route``.
    ``safe`` escalates jitter per failed member, as JAX's per-draw
    ``safe_cholesky`` in the mixture predictive (predictive.py:73-75)."""
    X, Y, sigma = _fleet_inputs(X, Y, sigma, device)
    with torch.no_grad():
        K = _fleet_gram(kernel, X, sigma**2 + jitter, batched_kernel)
        L, alpha, route = _factor_and_solve(K, Y, use_crout, safe)
    return BatchedGP(kernel=kernel, X=X, Y=Y, sigma=sigma, alpha=alpha, L=L,
                     batched_kernel=batched_kernel, route=route)


def fit_batched_sharded(kernel, X, Y, sigma, mesh=None, axis: str = "fleet", jitter: float = 0.0,
                        batched_kernel: bool = False, use_crout: Optional[bool] = None,
                        device=None) -> BatchedGP:
    """:func:`fit_batched` with the B members split over dimension ``axis``
    of ``mesh`` (default: a 1-D mesh over every rank), as
    batched.py:239-305: every rank passes the whole fleet (X (B, n, d), Y,
    sigma, and with ``batched_kernel`` the kernel's (B,) leaves), B divisible
    by the mesh size, and gets the ``BatchedGP`` of its B / D members, whose
    route is :func:`fit_batched`'s."""
    from ..parallel import sharded_gram

    if mesh is None:
        mesh = sharded_gram.default_mesh(axis=axis, device=device)
    ax = sharded_gram._Axis(mesh, axis)
    X, Y, sigma = _fleet_inputs(X, Y, sigma, sharded_gram.mesh_device(mesh))
    B = X.shape[0]
    if B % ax.size:
        raise ValueError(f"fleet size ({B}) must be divisible by mesh ({ax.size})")
    lo, hi = ax.rank * B // ax.size, (ax.rank + 1) * B // ax.size
    if batched_kernel:
        kernel = kernel.with_params([torch.as_tensor(p)[lo:hi] for p in kernel.params])
    return fit_batched(kernel, X[lo:hi], Y[lo:hi], sigma[lo:hi], jitter, batched_kernel, use_crout)


def predict_batched(gp: BatchedGP, Xs) -> torch.Tensor:
    """Posterior means: Xs (B, m, d) -> (B, m, q) (batched.py:179-188)."""
    Xs = torch.as_tensor(Xs, dtype=gp.X.dtype, device=gp.X.device)

    def one(k, xs, x, a):
        return kermod.gram(k, xs, x) @ a

    return kermod.fleet_map(one, gp.kernel, gp.batched_kernel, Xs, gp.X, gp.alpha)


def variance_batched(gp: BatchedGP, Xs) -> torch.Tensor:
    """Diagonal posterior variance: Xs (B, m, d) -> (B, m) (batched.py:191-202)."""
    Xs = torch.as_tensor(Xs, dtype=gp.X.dtype, device=gp.X.device)

    def one(k, xs, x, L):
        Ks = kermod.gram(k, xs, x)  # (m, n)
        solved = linalg.cho_solve(L, Ks.T)
        return k._eval(xs, xs) - (Ks * solved.T).sum(-1)

    return kermod.fleet_map(one, gp.kernel, gp.batched_kernel, Xs, gp.X, gp.L)


def mll_batched(kernel, X, Y, sigma, batched_kernel: bool = False,
                use_crout: Optional[bool] = None, device=None) -> torch.Tensor:
    """Per-member log marginal likelihoods (B,), each as
    ``likelihood.mll_scalar`` counts it: datafit summed over the outputs,
    complexity and constant once (batched.py:205-236).  Differentiable in
    the kernel's hyperparameters on both routes."""
    X, Y, sigma = _fleet_inputs(X, Y, sigma, device)
    n = X.shape[1]
    K = kermod.fleet_map(_noisy_gram, kernel, batched_kernel, X, sigma**2)
    L, alpha, _ = _factor_and_solve(K, Y, use_crout)
    df = -0.5 * (Y * alpha).sum((1, 2))
    cp = -torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
    return df + cp - n / 2.0 * math.log(2 * math.pi)


def fit_mle_batched(kernel, X, Y, sigma, iterations: int = 200, learning_rate: float = 0.05,
                    log_space: bool = True, use_crout: Optional[bool] = None, init=None,
                    device=None):
    """Per-member MLE of a whole fleet in one Adam loop over the (B, P)
    hyperparameters of ``sum(mll_batched)``, whose gradient never mixes
    members (batched.py:308-372).  ``kernel`` is a scalar-leaf template,
    the shared start unless ``init`` (B, P) is given.  Returns
    ``(batched kernel, OptResult)`` with ``OptResult.params`` (B, P)."""
    X, Y, sigma = _fleet_inputs(X, Y, sigma, device)
    B = X.shape[0]
    vec0 = kermod.params_vector(kernel).detach()
    P = vec0.shape[0]
    if init is None:
        v0 = vec0[None, :].expand(B, P)
    else:
        v0 = torch.as_tensor(init, dtype=vec0.dtype)
        if v0.shape != (B, P):
            raise ValueError(f"fit_mle_batched: init shape {tuple(v0.shape)} != {(B, P)}")

    def mk_kernel(vecs):
        return kernel.with_params([vecs[:, i] for i in range(P)])

    def objective(vecs):
        if log_space:
            vecs = torch.exp(vecs)
        return mll_batched(mk_kernel(vecs), X, Y, sigma, batched_kernel=True,
                           use_crout=use_crout).sum()

    x0 = torch.log(v0) if log_space else v0
    x, final, trace = _run_adam(objective, x0, learning_rate, iterations)
    params = torch.exp(x) if log_space else x
    res = OptResult(params=params, value=final, trace=trace,
                    route=fleet_route(X.shape[1], X.dtype, X.device, use_crout))
    return mk_kernel(params), res
