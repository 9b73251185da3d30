"""Posterior-predictive GP: predictions mixed over hyperparameter draws.

Mirrors gpr_tpu/inference/predictive.py:26-163 (``PredictiveResult``,
``subsample_draws``, ``predictive``, ``predictive_from_hmc``,
``predictive_sharded``).  The
predictive distribution is a mixture over posterior draws: mean = E[mean_s],
variance = E[var_s + mean_s^2] - mean^2.

The S draws are one fleet of S GPs that share X and Y, one hyperparameter
leaf a draw: ``gp.batched.fit_batched`` with the safe fleet factor (JAX
escalates jitter per draw, predictive.py:73-75), so on the card in float32
the Gram is K6 gram_batched and the factor K7 crout_chol on every diagonal
block (``fleet-crout``; ``fleet-fused`` under ``GPR_FLEET_FUSED_MAX_N``).
The means are ``predict_batched``'s, the variances ``variance_batched``'s
form, plus sigma^2 with ``include_noise``.  ``predictive_sharded``
(predictive.py:108-163) splits the draws over the ranks of a device mesh and
combines the mixture's moments by all-reduce means.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..gp import batched as fleet
from ..utils import config


class PredictiveResult(NamedTuple):
    mean: torch.Tensor               # (m, q)
    variance: torch.Tensor           # (m,) marginal predictive variance (with noise)
    mean_per_draw: torch.Tensor      # (S, m, q)
    variance_per_draw: torch.Tensor  # (S, m)


def subsample_draws(samples, num: int) -> torch.Tensor:
    """``num`` evenly spaced parameter vectors (num, dim) in natural space
    from (chains, T, dim) draws in log space (predictive.py:33-38).  The
    indices are JAX's float64 ``linspace(0, N - 1, num)`` truncated to int32,
    as XLA evaluates it: its start (1 - s) + stop s with s = i / (num - 1)
    becomes i * ((N - 1) * (1 / (num - 1))) once the division by a constant
    is a product and the zero start folds away, the last point exactly N - 1.
    Other roundings of the same points land up to one index off (at
    N = 100, num = 100: 3 of 100)."""
    samples = torch.as_tensor(samples)
    z = samples.reshape(-1, samples.shape[-1])
    last = float(z.shape[0] - 1)
    if num > 1:
        step = last * (1.0 / (num - 1))
        pts = np.append(np.arange(num - 1, dtype=np.float64) * step, last)
    else:
        pts = np.zeros(max(num, 0))
    idx = torch.as_tensor(pts.astype(np.int32).astype(np.int64), device=z.device)
    return torch.exp(z[idx])


def predictive(kernel, theta_draws, X, Y, Xs, sigma, include_noise: bool = True,
               use_crout: Optional[bool] = None, device=None) -> PredictiveResult:
    """The mixture predictive over ``theta_draws`` (S, p), natural space,
    reference order (predictive.py:41-96); ``sigma`` the noise std, a scalar
    or (S,).  ``kernel`` gives the form.  The draws' fit runs on
    ``fit_batched``'s route (``use_crout`` as there)."""
    X = config.as_input(X, device)
    X = X[:, None] if X.ndim == 1 else X
    Y = config.as_input(Y, X.device).to(X.dtype)
    Y = Y[:, None] if Y.ndim == 1 else Y
    Xs = config.as_input(Xs, X.device).to(X.dtype)
    Xs = Xs[:, None] if Xs.ndim == 1 else Xs
    theta = torch.as_tensor(theta_draws, device=X.device)
    S = theta.shape[0]
    sigmas = torch.as_tensor(sigma, dtype=X.dtype, device=X.device).expand(S)
    kb = kernel.with_params([theta[:, i] for i in range(theta.shape[1])])

    def per_draw(t):
        return t.expand(S, *t.shape).contiguous()

    gp = fleet.fit_batched(kb, per_draw(X), per_draw(Y), sigmas, batched_kernel=True,
                           use_crout=use_crout, safe=True)
    Xsb = per_draw(Xs)
    with torch.no_grad():
        means = fleet.predict_batched(gp, Xsb)
        var = fleet.variance_batched(gp, Xsb)
    if include_noise:
        var = var + (sigmas**2)[:, None]
    variances = torch.clamp(var, min=0.0)

    mix_mean = means.mean(0)
    # total variance = E[var] + the spread of the draws' means over the outputs
    q = means.shape[-1]
    mean_sq = ((means**2).sum(-1) / q).mean(0)
    mix_sq = (mix_mean**2).sum(-1) / q
    mix_var = variances.mean(0) + torch.clamp(mean_sq - mix_sq, min=0.0)
    return PredictiveResult(mean=mix_mean, variance=mix_var, mean_per_draw=means,
                            variance_per_draw=variances)


def predictive_from_hmc(kernel, result, X, Y, Xs, sigma, num_draws: int = 32,
                        include_noise: bool = True, use_crout: Optional[bool] = None,
                        device=None) -> PredictiveResult:
    """Thin an ``HMCResult`` / ``NUTSResult`` to ``num_draws`` and mix
    (predictive.py:99-105)."""
    theta = subsample_draws(result.samples, num_draws)
    return predictive(kernel, theta, X, Y, Xs, sigma, include_noise, use_crout, device)


def predictive_sharded(kernel, theta_draws, X, Y, Xs, sigma, mesh=None, axis: str = "draws",
                       include_noise: bool = True, use_crout: Optional[bool] = None,
                       device=None) -> PredictiveResult:
    """:func:`predictive` with the S draws split over dimension ``axis`` of
    ``mesh`` (default: a 1-D mesh over every rank), as predictive.py:108-163:
    each rank mixes its S / D draws, and the mixture's moments combine by
    all-reduce means in JAX's order.  Every rank passes all draws (S
    divisible by the mesh size) and ``sigma`` a scalar or (S,); ``mean`` and
    ``variance`` come back the same on every rank, the per-draw arrays are
    the rank's."""
    from ..parallel import sharded_gram

    if mesh is None:
        mesh = sharded_gram.default_mesh(axis=axis, device=device)
    ax = sharded_gram._Axis(mesh, axis)
    theta = config.as_input(theta_draws, sharded_gram.mesh_device(mesh))
    S = theta.shape[0]
    if S % ax.size:
        raise ValueError(f"num draws ({S}) must be divisible by mesh size ({ax.size})")
    lo, hi = ax.rank * S // ax.size, (ax.rank + 1) * S // ax.size
    X = config.as_input(X, theta.device)
    sigmas = torch.as_tensor(sigma, dtype=X.dtype, device=theta.device).expand(S)
    res = predictive(kernel, theta[lo:hi], X, Y, Xs, sigmas[lo:hi], include_noise, use_crout)
    means = res.mean_per_draw
    q = means.shape[-1]
    mean = ax.mean(means.mean(0))
    e_var = ax.mean(res.variance_per_draw.mean(0))
    e_msq = ax.mean(((means**2).sum(-1) / q).mean(0))
    var = e_var + torch.clamp(e_msq - (mean**2).sum(-1) / q, min=0.0)
    return PredictiveResult(mean=mean, variance=var, mean_per_draw=means,
                            variance_per_draw=res.variance_per_draw)
