"""Mean-field ADVI over GP hyperparameters.

Mirrors gpr_tpu/inference/advi.py:37-111 (``ADVIResult``, ``fit_advi``), the
VI leg beside the samplers.  q(z) = N(mu, diag(sigma^2)) over the same
unconstrained z as ``hmc.make_gp_log_posterior``; the ELBO

    ELBO(mu, omega) = E_{eps ~ N(0, I)}[logp(mu + exp(omega) * eps)]
                      + sum(omega) + dim / 2 * log(2 pi e)

is maximized by Adam with the reparameterization trick.  Each step's Monte
Carlo expectation is one batched ``logp_fn`` call on (num_samples, dim): on
the GP log posterior, a fleet of ``num_samples`` GPs, the compute shape of
as many HMC chains.

The optimizer is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2
0.999, eps 1e-8) under optax's ``cosine_decay_schedule(lr, num_steps)``
(alpha 0): step k (from 0) runs at lr * 0.5 (1 + cos(pi k / num_steps)).
The noise of all steps is drawn up front from the generator, (num_steps,
num_samples, dim).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from . import hmc


class ADVIResult(NamedTuple):
    mean: torch.Tensor        # (dim,) posterior mean of z
    std: torch.Tensor         # (dim,) posterior std of z
    elbo: torch.Tensor        # final ELBO estimate (scalar)
    elbo_trace: torch.Tensor  # (num_steps,) per-step ELBO estimates

    def sample(self, generator, num_samples: int = 1) -> torch.Tensor:
        """(num_samples, dim) draws from q, e.g. for the mixture predictive."""
        gen = hmc._generator(generator, self.mean.device)
        eps = torch.randn((num_samples, self.mean.shape[0]), generator=gen,
                          dtype=self.mean.dtype, device=self.mean.device)
        return self.mean[None, :] + self.std[None, :] * eps


def _cosine_decay(learning_rate: float, num_steps: int, count: int) -> float:
    # optax.cosine_decay_schedule(learning_rate, num_steps), alpha = 0
    count = min(count, num_steps)
    return learning_rate * (0.5 * (1.0 + math.cos(math.pi * count / num_steps)))


def _run(logp_fn: Callable, z0: torch.Tensor, noise: torch.Tensor, learning_rate: float,
         init_log_std: float) -> ADVIResult:
    """The optimization on given noise (num_steps, num_samples, dim)."""
    dim = z0.shape[0]
    ent_const = 0.5 * dim * math.log(2.0 * math.pi * math.e)
    mu = z0.detach().clone().requires_grad_(True)
    omega = torch.full((dim,), init_log_std, dtype=z0.dtype, device=z0.device, requires_grad=True)
    opt = torch.optim.Adam([mu, omega], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    num_steps = noise.shape[0]
    elbos = torch.empty(num_steps, dtype=z0.dtype, device=z0.device)
    for k in range(num_steps):
        for group in opt.param_groups:
            group["lr"] = _cosine_decay(learning_rate, num_steps, k)
        with torch.enable_grad():
            zs = mu[None, :] + torch.exp(omega)[None, :] * noise[k]
            loss = -(logp_fn(zs).mean() + omega.sum() + ent_const)
            mu.grad, omega.grad = torch.autograd.grad(loss, (mu, omega))
        opt.step()
        elbos[k] = -loss.detach()
    return ADVIResult(mean=mu.detach(), std=torch.exp(omega.detach()), elbo=elbos[-1],
                      elbo_trace=elbos)


def fit_advi(logp_fn: Callable, z0, generator, num_steps: int = 400, num_samples: int = 8,
             learning_rate: float = 0.05, init_log_std: float = -2.0, device=None) -> ADVIResult:
    """Fit q(z) = N(mu, diag(sigma^2)) to exp(logp_fn) by maximizing the
    reparameterized ELBO (advi.py:52-111).  ``logp_fn`` maps (S, dim) to
    (S,) (``hmc.make_gp_log_posterior`` works as it is); ``z0`` (dim,) seeds
    the mean; ``generator`` is a ``torch.Generator`` on z0's device or an
    int seed."""
    z0 = hmc._chains(z0, device).reshape(-1)
    gen = hmc._generator(generator, z0.device)
    noise = torch.randn((num_steps, num_samples, z0.shape[0]), generator=gen, dtype=z0.dtype,
                        device=z0.device)
    return _run(logp_fn, z0, noise, learning_rate, init_log_std)
