"""Hamiltonian Monte Carlo over GP hyperparameters.

Mirrors gpr_tpu/inference/hmc.py:44-83 (``_shrunk_mass``, ``_tree_mean``),
111-152 (``make_gp_log_posterior``, ``make_sparse_gp_log_posterior``),
159-283 (the configuration, the chain state, ``_leapfrog``,
``_hmc_transition``, ``HMCResult``, ``ShardCtx``), 285-584 (the dual-averaging warmup,
``_window_schedule``, ``init_chains``, ``_adapt_phase``, ``sample_hmc``),
585-706 (``sample_hmc_chunked``) and
713-841 (diagnostics, chain checkpoints, ``resume_hmc``).  Instead of the
reference's point estimate (include/GaussianProcessInference.h:84-229) the
hyperparameter posterior is sampled, in log space (theta = exp(z), the
Jacobian sum(z) in the log posterior).

The C chains are one batch.  A log posterior maps z (C, dim) to (C,), and
its members never mix, so one ``autograd.grad`` of the sum is every chain's
gradient.  :func:`make_gp_log_posterior` evaluates the chains as one fleet
of C GPs that share X and Y, one hyperparameter leaf a chain, on the fleet
route of gp/batched.py (``logp.route``): on the card in float32 with n % 128
== 0 that is ``fleet-crout``, K7 crout_chol on every diagonal block of
every leapfrog step's factorization (``fleet-fused``, K9 forward and K8 in
the backward, under ``GPR_FLEET_FUSED_MAX_N``).  JAX vmaps ``mll_scalar``
over the chains, whose batched factor retries failed members with jitter
(linalg.py:197-203); the fleet does the same by
``ops.batched.factor_solve_safe``.

A chain whose position leaves the range where exp(z) is finite and positive
gets a NaN log posterior and gradient, as in JAX, and the Metropolis step
rejects it; the kernel classes' validation (which raises) never sees its
values.

Randomness comes from a ``torch.Generator`` on the chains' device (or an
int seed for one).  Each transition is split into its draws
(:func:`_hmc_draws`: the momentum, each chain's step count, the accept
uniform) and a deterministic step (:func:`_hmc_step`) that takes them, so
that a test can feed it JAX's draws.  The draws are not JAX's key flow; the
stream is one generator consumed in a fixed order, the same in
:func:`sample_hmc` and :func:`sample_hmc_chunked`.

The host reads one bool per log-posterior evaluation (the safe factor's
success check) and the largest step count once per transition.

Chains split over ranks come in two forms, as in JAX.
``cross_chain_mean`` / ``cross_chain_moments`` are plain callables that
combine the warmup's statistics with other ranks' chains
(``parallel.sharded_hmc.sample_hmc_sharded``).  With a :class:`ShardCtx`
(``parallel.sharded_hmc.sample_hmc_sharded_chunked``) a rank runs its block
of the chains and every result equals the single-process run's bit for bit:
each transition draws the randomness of all ``n_global`` chains from the
generator, seeded alike on every rank, in the single-process order, and
keeps the rank's rows (JAX slices its global key set, hmc.py:274-283); the
warmup's accept statistic is the tree mean of the all-gathered accept
vector (hmc.py:317-326); the mass is estimated from every chain's gathered
warmup draws; the draws come back gathered in chain order.  Bit for bit
holds where a chain's log posterior does not depend on how many chains
share its call, as on the CPU.  On the card the fleet's batched products
round with the fleet's size, so D ranks equal one process whose log
posterior takes the same fleets of n_global / D chains a call.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..gp import batched as fleet
from ..gp import likelihood as lk
from ..kernels import kernels as kermod
from ..ops import linalg
from ..utils import config


def _shrunk_mass(zs: torch.Tensor, drop: int = 0) -> torch.Tensor:
    """Stan-regularized diagonal inverse mass from warmup draws ``zs``
    (T, chains, dim), the first ``drop`` draws discarded (hmc.py:44-54)."""
    flat = zs[drop:].reshape(-1, zs.shape[-1])
    mean = flat.mean(0)
    var = ((flat - mean) ** 2).mean(0)
    w = flat.shape[0]
    return (w / (w + 5.0)) * var + (5.0 / (w + 5.0)) * 1e-3


def _da_init(eps0: torch.Tensor):
    """(mu, log_eps0) of dual averaging (hmc.py:57-60)."""
    return torch.log(10.0 * eps0), torch.log(eps0)


def _tree_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean of a 1-D vector by an explicit balanced tree of pairwise adds,
    an odd level padded with an exact zero (hmc.py:63-83): the order the
    dual-averaged step size is summed in, whatever the backend."""
    n = v.shape[0]
    m = v
    while m.shape[0] > 1:
        if m.shape[0] % 2:
            m = torch.cat([m, m.new_zeros(1)])
        m = m[0::2] + m[1::2]
    return m[0] / n


def _generator(generator, device) -> torch.Generator:
    """A ``torch.Generator`` as given, or one on ``device`` seeded with the int."""
    if isinstance(generator, torch.Generator):
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(int(generator))
    return g


def _chains(z0, device=None) -> torch.Tensor:
    z0 = config.as_input(z0, device)
    if not z0.is_floating_point():
        z0 = z0.to(torch.float64)
    return torch.atleast_2d(z0)


# ---------------------------------------------------------------------------
# the log posterior
# ---------------------------------------------------------------------------

def _chain_grams(kernel, leaves, X, noise):
    # K(X, X) + noise I for every chain's kernel: the fleet Gram of
    # gp/batched.py over X shared, one (C,) leaf a hyperparameter
    return torch.func.vmap(lambda ps: fleet._noisy_gram(kernel.with_params(ps), X, noise))(leaves)


def make_gp_log_posterior(kernel, X, Y, sigma, priors: Optional[Sequence] = None,
                          weight: float = 1.0, use_crout: Optional[bool] = None,
                          device=None) -> Callable:
    """log p(z | data) of every chain, z (C, dim) -> (C,) (hmc.py:111-129):
    weight * MLL(exp z) + sum_p log prior_p(exp z_p) + sum(z).

    ``kernel`` gives the form (its values are not used); ``priors`` one
    density or None per hyperparameter.  The MLL is ``likelihood.mll_scalar``'s
    (datafit summed over the outputs, the log-determinant once) for C GPs at
    once: the fleet Gram, then ``factor_solve_safe`` on ``fleet_route(n,
    dtype, device, use_crout)`` (``logp.route``: the route when it was built;
    the switches are read at each call, as ``fit_batched`` reads them).  Differentiable
    by autograd.  A chain whose exp(z) is not finite and positive gets NaN
    value and gradient."""
    X, Y = lk._inputs(X, Y, device)
    n, num = X.shape[0], kernel.num_params
    noise = torch.as_tensor(sigma, dtype=X.dtype, device=X.device) ** 2
    const = -n / 2.0 * math.log(2 * math.pi)
    per_chain_Y = {}  # Y once per member, by chain count

    def logp(z: torch.Tensor) -> torch.Tensor:
        theta = torch.exp(z)
        ok = (torch.isfinite(theta) & (theta > 0)).all(-1)
        safe = torch.where(ok[:, None], theta, 1.0)
        K = _chain_grams(kernel, [safe[:, i] for i in range(num)], X, noise)
        C = z.shape[0]
        if C not in per_chain_Y:
            per_chain_Y[C] = Y.expand(C, *Y.shape).contiguous()
        Yc = per_chain_Y[C]
        L, alpha, _ = fleet._factor_and_solve(K, Yc, use_crout, safe=True)
        val = weight * (-0.5 * (Yc * alpha).sum((1, 2)) - 0.5 * linalg.logdet_from_chol(L) + const)
        if priors is not None:
            for i, prior in enumerate(priors):
                if prior is not None:
                    val = val + prior.log_pdf(safe[:, i])
        # NaN value and gradient where exp(z) left the finite positive range
        poison = torch.where(ok, 0.0, torch.nan).to(z.dtype)
        return (val + z.sum(-1) + (z * poison[:, None]).sum(-1)).to(z.dtype)

    logp.route = fleet.fleet_route(n, X.dtype, X.device, use_crout)
    return logp


# rows of Knm a block of the chains' cross products (see _cross_products)
_CROSS_BLOCK = 1024


def _cross_products(Knm: torch.Tensor) -> torch.Tensor:
    """Kmn Knm of every chain, (C, m, m), summed over blocks of
    ``_CROSS_BLOCK`` rows, one batched GEMM a block.  One batched GEMM over
    all n rows is less accurate on the card: at n=16384 it gave the log
    posterior's float32 gradient 17x the plain float32 route's error on an H100
    (chip_tools/sparse_logp_probe.py); by blocks the error is one chain's
    GEMM's."""
    out = None
    for s in range(0, Knm.shape[-2], _CROSS_BLOCK):
        blk = Knm[:, s:s + _CROSS_BLOCK]
        out = blk.mT @ blk if out is None else torch.baddbmm(out, blk.mT, blk)
    return out


def make_sparse_gp_log_posterior(kernel, Z, X, Y, sigma, priors: Optional[Sequence] = None,
                                 jitter: float = 0.0, use_crout: Optional[bool] = None,
                                 device=None) -> Callable:
    """log p(z | data) of every chain under the sparse model, z (C, dim) ->
    (C,) (hmc.py:132-152): ``gp.sparse.sparse_mll_scalar(exp z)`` + sum_p log
    prior_p(exp z_p) + sum(z), with the inducing inputs Z fixed.

    Each chain's Kmm + jitter I and Woodbury inner matrix Kmm + s^-2 Kmn Knm
    are factored together, one fleet of 2C (m, m) matrices, by
    ``gp/batched.py::_factor_and_solve(..., safe=True)`` on ``fleet_route(m,
    dtype, device, use_crout)`` (``logp.route``): on the card in float32 with
    m % 128 == 0 that is ``fleet-crout``, K7 on every diagonal block.  Each
    member escalates its own jitter, as JAX's vmapped ``safe_cholesky``
    does.  The cross Gram Knm is (C, n, m), its products summed by row
    blocks (:func:`_cross_products`); differentiable by autograd.  A
    chain whose exp(z) is not finite and positive gets NaN value and
    gradient."""
    X, Y = lk._inputs(X, Y, device)
    Z = torch.atleast_2d(config.as_input(Z, X.device)).to(X.dtype)
    n, num = X.shape[0], kernel.num_params
    s2 = torch.as_tensor(sigma, dtype=X.dtype, device=X.device) ** 2
    const = -n / 2.0 * math.log(2 * math.pi) - 0.5 * n * torch.log(s2)

    def grams(k):
        return linalg.add_diagonal(kermod.gram(k, Z), jitter), kermod.gram(k, X, Z)

    def logp(z: torch.Tensor) -> torch.Tensor:
        theta = torch.exp(z)
        ok = (torch.isfinite(theta) & (theta > 0)).all(-1)
        safe = torch.where(ok[:, None], theta, 1.0)
        Kmm, Knm = torch.func.vmap(lambda ps: grams(kernel.with_params(ps)))(
            [safe[:, i] for i in range(num)])
        C = z.shape[0]
        t = Knm.mT @ Y / s2  # (C, m, q)
        # one fleet call factors both matrices of every chain; the fleet's
        # factor and its solve are one pass over one (2C, m, q) right-hand
        # side, so the Kmm members solve zeros (q columns of batched GEMMs),
        # of which only their factor's log-determinant is used
        L, sol, _ = fleet._factor_and_solve(torch.cat([Kmm, Kmm + _cross_products(Knm) / s2]),
                                            torch.cat([torch.zeros_like(t), t]), use_crout, safe=True)
        CinvY = (Y - Knm @ sol[C:]) / s2  # the Woodbury solve (sparse.py:196-205)
        logdet = linalg.logdet_from_chol(L)
        val = -0.5 * (Y * CinvY).sum((1, 2)) - 0.5 * (logdet[C:] - logdet[:C]) + const
        if priors is not None:
            for i, prior in enumerate(priors):
                if prior is not None:
                    val = val + prior.log_pdf(safe[:, i])
        # NaN value and gradient where exp(z) left the finite positive range
        poison = torch.where(ok, 0.0, torch.nan).to(z.dtype)
        return (val + z.sum(-1) + (z * poison[:, None]).sum(-1)).to(z.dtype)

    logp.route = fleet.fleet_route(Z.shape[0], X.dtype, X.device, use_crout)
    return logp


def _value_and_grad(logp_fn: Callable) -> Callable:
    """z (C, dim) -> (logp (C,), grad (C, dim)), the members independent."""

    def logp_grad(z):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = logp_fn(zz)
            (g,) = torch.autograd.grad(v.sum(), zz, allow_unused=True)
        return v.detach(), torch.zeros_like(z) if g is None else g

    return logp_grad


# ---------------------------------------------------------------------------
# HMC core
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HMCConfig:
    num_warmup: int = 500
    num_samples: int = 500
    num_leapfrog: int = 16
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    max_step_size: float = 10.0
    jitter_steps: bool = True  # each chain draws its leapfrog count in [1, L]
    # Stan-style expanding-window warmup (opt-in), as hmc.py:159-172
    windowed_warmup: bool = False


class ChainState(NamedTuple):
    z: torch.Tensor     # positions (chains, dim)
    logp: torch.Tensor  # cached log posterior (chains,)
    grad: torch.Tensor  # cached gradient (chains, dim)


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    step: torch.Tensor


class HMCDraws(NamedTuple):
    """One transition's randomness: standard-normal momentum noise (chains,
    dim), each chain's leapfrog count (chains,) or None (every chain takes
    ``num_leapfrog``), and the accept uniforms (chains,)."""

    normal: torch.Tensor
    n_steps: Optional[torch.Tensor]
    u: torch.Tensor


class HMCResult(NamedTuple):
    samples: torch.Tensor      # (chains, num_samples, dim) in LOG space
    accept_rate: torch.Tensor  # (chains,)
    step_size: torch.Tensor    # final adapted step size (scalar)
    inv_mass: torch.Tensor     # final diagonal inverse mass (dim,)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The chains split over dimension ``axis`` of ``mesh`` (a torch
    ``DeviceMesh``), ``n_global`` of them in all (hmc.py:252-271): the
    rank r of D runs chains r n_local .. (r + 1) n_local, n_local =
    n_global / D."""

    mesh: object
    axis: str
    n_global: int

    @functools.cached_property
    def ax(self):
        from ..parallel.sharded_gram import _Axis

        return _Axis(self.mesh, self.axis)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a tensor over all chains."""
        nl = self.n_global // self.ax.size
        return t[self.ax.rank * nl:(self.ax.rank + 1) * nl]


def _leapfrog(logp_grad_fn, z, p, grad, eps, inv_mass, n_steps):
    """Leapfrog steps of every chain; returns (z', p', grad', logp')
    (hmc.py:188-210).  ``n_steps`` is an int or one count a chain: the batch
    runs the largest, and a chain whose count is done keeps its z, p, grad
    and logp exactly, as JAX's vmapped ``fori_loop`` leaves it."""
    logp = torch.full(z.shape[:1], -torch.inf, dtype=z.dtype, device=z.device)
    per_chain = isinstance(n_steps, torch.Tensor)
    for i in range(int(n_steps.max()) if per_chain else n_steps):
        p1 = p + 0.5 * eps * grad
        z1 = z + eps * inv_mass * p1
        lp1, g1 = logp_grad_fn(z1)
        p1 = p1 + 0.5 * eps * g1
        if per_chain:
            on = i < n_steps
            z, p = torch.where(on[:, None], z1, z), torch.where(on[:, None], p1, p)
            grad, logp = torch.where(on[:, None], g1, grad), torch.where(on, lp1, logp)
        else:
            z, p, grad, logp = z1, p1, g1, lp1
    return z, p, grad, logp


def _hmc_draws(generator: torch.Generator, state: ChainState, cfg: HMCConfig,
               shard_ctx: Optional[ShardCtx] = None) -> HMCDraws:
    """The randomness of one HMC transition (hmc.py:215-234), in this order:
    momentum noise, step counts (with ``cfg.jitter_steps``), uniforms.  With
    ``shard_ctx``, those of all chains, of which the rank's rows are kept."""
    z = state.z
    C = z.shape[0] if shard_ctx is None else shard_ctx.n_global
    normal = torch.randn((C, z.shape[1]), generator=generator, dtype=z.dtype, device=z.device)
    n_steps = None
    if cfg.jitter_steps:
        n_steps = torch.randint(1, cfg.num_leapfrog + 1, (C,), generator=generator, device=z.device)
    u = torch.rand((C,), generator=generator, dtype=z.dtype, device=z.device)
    draws = HMCDraws(normal, n_steps, u)
    if shard_ctx is None:
        return draws
    return HMCDraws(*(None if d is None else shard_ctx.local(d) for d in draws))


def _hmc_step(logp_grad_fn, state: ChainState, draws: HMCDraws, eps, inv_mass,
              cfg: HMCConfig):
    """The deterministic part of one HMC transition: the proposal from the
    drawn momentum N(0, M) (M = 1 / inv_mass) and the Metropolis accept
    (hmc.py:213-241).  Returns (state', accept_prob)."""
    z = state.z
    inv_mass = inv_mass.to(z.dtype)
    p0 = draws.normal / torch.sqrt(inv_mass)
    n_steps = cfg.num_leapfrog if draws.n_steps is None else draws.n_steps
    z1, p1, grad1, logp1 = _leapfrog(logp_grad_fn, z, p0, state.grad, eps, inv_mass, n_steps)
    ke0 = 0.5 * (inv_mass * p0 * p0).sum(-1)
    ke1 = 0.5 * (inv_mass * p1 * p1).sum(-1)
    log_accept = (logp1 - ke1) - (state.logp - ke0)
    log_accept = torch.where(torch.isnan(log_accept), -torch.inf, log_accept)
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    accept = draws.u < accept_prob
    new_state = ChainState(
        z=torch.where(accept[:, None], z1, z),
        logp=torch.where(accept, logp1, state.logp),
        grad=torch.where(accept[:, None], grad1, state.grad),
    )
    return new_state, accept_prob


def _hmc_transition(logp_grad_fn, state: ChainState, generator, eps, inv_mass, cfg: HMCConfig,
                    shard_ctx: Optional[ShardCtx] = None):
    """One HMC proposal + Metropolis accept of every chain (of the rank's)."""
    return _hmc_step(logp_grad_fn, state, _hmc_draws(generator, state, cfg, shard_ctx), eps,
                     inv_mass, cfg)


def _warmup_scan(logp_grad_fn, states: ChainState, generator, eps0, inv_mass, cfg, n_steps: int,
                 target: float, cross_chain_mean: Optional[Callable] = None,
                 transition: Optional[Callable] = None, shard_ctx: Optional[ShardCtx] = None):
    """``n_steps`` transitions under a step size shared by all chains and
    dual-averaged on their mean accept statistic (hmc.py:285-428).
    ``transition(states, generator, eps, inv_mass) -> (states', accept
    (chains,))`` defaults to HMC's; NUTS passes its own.  Returns (states,
    exp(log_eps_bar), zs (n_steps, chains, dim), mean accepts (n_steps,));
    with ``shard_ctx`` the states and zs are the rank's chains, the mean
    over all chains."""
    if transition is None:
        def transition(s, g, eps, im):
            return _hmc_transition(logp_grad_fn, s, g, eps, im, cfg, shard_ctx)

    mu, log_eps = _da_init(eps0)
    log_eps_bar = log_eps
    t0, gamma, kappa = 10.0, 0.05, 0.75
    h_bar = torch.zeros((), dtype=states.z.dtype, device=states.z.device)
    t = torch.zeros_like(h_bar)
    zs, accepts = [], []
    for _ in range(n_steps):
        states, accept_probs = transition(states, generator, torch.exp(log_eps), inv_mass)
        if shard_ctx is not None:
            # the single-process reduction over every chain, so the step
            # size is bit for bit the single-process one
            mean_accept = _tree_mean(shard_ctx.ax.gather(accept_probs))
        else:
            mean_accept = _tree_mean(accept_probs)
            if cross_chain_mean is not None:
                mean_accept = cross_chain_mean(mean_accept)
        t = t + 1.0
        eta_h = 1.0 / (t + t0)
        h_bar = (1 - eta_h) * h_bar + eta_h * (target - mean_accept)
        log_eps = mu - torch.sqrt(t) / gamma * h_bar
        log_eps = torch.clamp(log_eps, max=math.log(cfg.max_step_size))
        eta_x = t ** (-kappa)
        log_eps_bar = eta_x * log_eps + (1 - eta_x) * log_eps_bar
        zs.append(states.z)
        accepts.append(mean_accept)
    return states, torch.exp(log_eps_bar), torch.stack(zs), torch.stack(accepts)


def _window_schedule(num_warmup: int):
    """(head, [window sizes], tail): a 15 % step-size head, doubling mass
    windows over the middle 75 %, a 10 % step-size tail (hmc.py:431-447)."""
    head = max(int(0.15 * num_warmup), 1)
    tail = max(int(0.10 * num_warmup), 1)
    mid = max(num_warmup - head - tail, 1)
    w = max(mid // 7, 1)
    wins = []
    rem = mid
    while rem > 0:
        take = min(w, rem)
        if rem - take < max(mid // 7, 1):
            take = rem
        wins.append(take)
        rem -= take
        w *= 2
    return head, wins, tail


def init_chains(logp_fn: Callable, z0: torch.Tensor) -> ChainState:
    """z0: (chains, dim) initial positions (hmc.py:450-454)."""
    logp, grad = _value_and_grad(logp_fn)(z0)
    return ChainState(z=z0, logp=logp, grad=grad)


def _adapt_phase(logp_grad_fn, states: ChainState, generator, cfg, dim: int, dtype,
                 cross_chain_mean: Optional[Callable], cross_chain_moments: Optional[Callable],
                 transition: Optional[Callable] = None, shard_ctx: Optional[ShardCtx] = None):
    """The warmup every sampler shares (hmc.py:457-539): the dual-averaged
    step size and the diagonal mass, two stages by default, Stan-style
    expanding windows with ``cfg.windowed_warmup``.  Returns (states,
    step_size, inv_mass).  With ``shard_ctx`` the mass sees every rank's
    warmup draws."""
    device = states.z.device
    inv_mass = torch.ones((dim,), dtype=dtype, device=device)
    eps_init = torch.tensor(cfg.initial_step_size, dtype=dtype, device=device)

    def estimate_mass(zs, drop: int = 0):
        if shard_ctx is not None:
            zs = shard_ctx.ax.gather(zs, 1)
        if cross_chain_moments is None:
            return _shrunk_mass(zs, drop=drop)
        flat = zs[drop:].reshape(-1, dim)
        mean = flat.mean(0)
        var = ((flat - mean) ** 2).mean(0)
        # the hook combines the moments across devices and scales the count
        mean, var, w = cross_chain_moments(mean, var, flat.shape[0])
        return (w / (w + 5.0)) * var + (5.0 / (w + 5.0)) * 1e-3

    def scan(states, eps, inv_mass, n):
        return _warmup_scan(logp_grad_fn, states, generator, eps, inv_mass, cfg, n,
                            cfg.target_accept, cross_chain_mean, transition, shard_ctx)

    if cfg.windowed_warmup:
        head, wins, tail_n = _window_schedule(cfg.num_warmup)
        states, eps, _, _ = scan(states, eps_init, inv_mass, head)
        for win in wins:
            states, eps, zs_w, _ = scan(states, eps, inv_mass, win)
            inv_mass = estimate_mass(zs_w)
        states, eps2, _, _ = scan(states, eps, inv_mass, tail_n)
    else:
        n_w1 = max(cfg.num_warmup // 2, 1)
        n_w2 = max(cfg.num_warmup - n_w1, 1)
        # stage 1: the step size under unit mass
        states, eps1, zs1, _ = scan(states, eps_init, inv_mass, n_w1)
        # the mass from the second half of stage 1's draws, all chains
        inv_mass = estimate_mass(zs1, drop=n_w1 // 2)
        # stage 2: the step size again under the new metric
        states, eps2, _, _ = scan(states, eps1, inv_mass, n_w2)
    return states, eps2, inv_mass


def _sample_loop(transition: Callable, states: ChainState, generator, eps, inv_mass,
                 num_samples: int):
    """``num_samples`` transitions at a fixed step size and mass: (states,
    zs (T, chains, dim), accept statistics (T, chains))."""
    zs, accepts = [], []
    for _ in range(num_samples):
        states, a = transition(states, generator, eps, inv_mass)
        zs.append(states.z)
        accepts.append(a)
    return states, torch.stack(zs), torch.stack(accepts)


def _result(cls, zs, accepts, eps, inv_mass):
    return cls(samples=zs.transpose(0, 1), accept_rate=accepts.mean(0), step_size=eps,
               inv_mass=inv_mass)


def sample_hmc(logp_fn: Callable, z0, generator, cfg: HMCConfig = HMCConfig(),
               cross_chain_mean: Optional[Callable] = None,
               cross_chain_moments: Optional[Callable] = None, device=None) -> HMCResult:
    """HMC chains from z0 (chains, dim) in log space (hmc.py:542-582): the
    warmup of :func:`_adapt_phase`, then ``cfg.num_samples`` transitions.
    ``generator`` is a ``torch.Generator`` on the chains' device or an int
    seed; ``cross_chain_mean`` / ``cross_chain_moments`` combine the
    adaptation statistics with other processes' chains."""
    z0 = _chains(z0, device)
    gen = _generator(generator, z0.device)
    logp_grad_fn = _value_and_grad(logp_fn)
    states = init_chains(logp_fn, z0)
    states, eps2, inv_mass = _adapt_phase(logp_grad_fn, states, gen, cfg, z0.shape[1], z0.dtype,
                                          cross_chain_mean, cross_chain_moments)

    def transition(s, g, eps, im):
        return _hmc_transition(logp_grad_fn, s, g, eps, im, cfg)

    _, zs, accepts = _sample_loop(transition, states, gen, eps2, inv_mass, cfg.num_samples)
    return _result(HMCResult, zs, accepts, eps2, inv_mass)


def _chunked(transition, states, generator, eps, inv_mass, num_samples: int, chunk_size: int):
    zs_parts, acc_parts = [], []
    for start in range(0, num_samples, chunk_size):
        states, zs_c, acc_c = _sample_loop(transition, states, generator, eps, inv_mass,
                                           min(chunk_size, num_samples - start))
        zs_parts.append(zs_c)
        acc_parts.append(acc_c)
    return torch.cat(zs_parts), torch.cat(acc_parts)


def _chunk_size(chunk_size, num_samples: int) -> int:
    if isinstance(chunk_size, bool) or not isinstance(chunk_size, (int, np.integer)):
        raise TypeError(f"chunk_size must be an int, got {chunk_size!r}")
    # clamped as hmc.py:622-625 clamps it
    return max(1, min(int(chunk_size), num_samples))


def _sharded_chains(z0, shard_ctx: Optional[ShardCtx]) -> torch.Tensor:
    """The rank's rows of all chains' z0, checked against ``shard_ctx``."""
    if shard_ctx is None:
        return z0
    if z0.shape[0] != shard_ctx.n_global or shard_ctx.n_global % shard_ctx.ax.size:
        raise ValueError(f"{z0.shape[0]} chains for a ShardCtx of {shard_ctx.n_global} over "
                         f"{shard_ctx.ax.size} ranks")
    return shard_ctx.local(z0)


def _gathered(zs, accepts, shard_ctx: Optional[ShardCtx]):
    if shard_ctx is None:
        return zs, accepts
    return shard_ctx.ax.gather(zs, 1), shard_ctx.ax.gather(accepts, 1)


def sample_hmc_chunked(logp_fn: Callable, z0, generator, cfg: HMCConfig = HMCConfig(),
                       chunk_size: int = 64, cross_chain_mean: Optional[Callable] = None,
                       cross_chain_moments: Optional[Callable] = None,
                       shard_ctx: Optional[ShardCtx] = None, device=None) -> HMCResult:
    """:func:`sample_hmc` with the sampling stage in chunks of ``chunk_size``
    transitions (hmc.py:585-706), ``chunk_size`` clamped to [1,
    num_samples].  The same transitions and the same generator stream, so
    the draws equal :func:`sample_hmc`'s bit for bit.  JAX's chunk programs
    (python-unrolled transitions under jit) work around the remote TPU
    backend's compile time for a scan over a transition; the port has no
    compiled programs, and the chunks only bound how many draws a stage
    holds before concatenation.

    With ``shard_ctx`` every rank passes all chains' z0 and the same
    generator seed, runs its block of the chains and returns all chains'
    result, equal to the single-process run's bit for bit (see the module
    docstring)."""
    z0 = _chains(z0, device)
    chunk_size = _chunk_size(chunk_size, cfg.num_samples)
    gen = _generator(generator, z0.device)
    logp_grad_fn = _value_and_grad(logp_fn)
    z_local = _sharded_chains(z0, shard_ctx)
    states = init_chains(logp_fn, z_local)
    states, eps2, inv_mass = _adapt_phase(logp_grad_fn, states, gen, cfg, z0.shape[1], z0.dtype,
                                          cross_chain_mean, cross_chain_moments,
                                          shard_ctx=shard_ctx)

    def transition(s, g, eps, im):
        return _hmc_transition(logp_grad_fn, s, g, eps, im, cfg, shard_ctx)

    zs, accepts = _chunked(transition, states, gen, eps2, inv_mass, cfg.num_samples, chunk_size)
    return _result(HMCResult, *_gathered(zs, accepts, shard_ctx), eps2, inv_mass)


# ---------------------------------------------------------------------------
# diagnostics (hmc.py:713-762)
# ---------------------------------------------------------------------------

def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split-R-hat per dimension.  samples: (chains, T, dim)."""
    samples = torch.as_tensor(samples)
    half = samples.shape[1] // 2
    x = torch.cat([samples[:, :half], samples[:, half:2 * half]], 0)
    n = x.shape[1]
    chain_mean = x.mean(1)
    chain_var = x.var(1, correction=1)
    B = n * chain_mean.var(0, correction=1)
    W = chain_var.mean(0)
    var_hat = (n - 1) / n * W + B / n
    return torch.sqrt(var_hat / W)


def effective_sample_size(samples: torch.Tensor, max_lag: int = 100) -> torch.Tensor:
    """Bulk ESS per dimension from the autocorrelation (Geyer's initial
    positive sequence, truncated at ``max_lag``).  samples: (chains, T, dim)."""
    samples = torch.as_tensor(samples)
    c, t, d = samples.shape
    x = samples - samples.mean(1, keepdim=True)
    max_lag = min(max_lag, t - 1)
    if max_lag < 1:
        # a single draw carries no autocorrelation
        return torch.full((d,), float(c * t), dtype=samples.dtype, device=samples.device)
    acovs = torch.stack([(x[:, :t - lag] * x[:, lag:]).mean((0, 1)) for lag in range(max_lag)])
    # a stuck chain has zero variance: rho = 0 there, so ess is c * t, not NaN
    pos = acovs[0] > 0
    rho = torch.where(pos, acovs / torch.where(pos, acovs[0], 1.0), torch.zeros_like(acovs))
    positive = torch.cumprod((rho > 0).to(samples.dtype), 0)
    tau = 1.0 + 2.0 * (rho[1:] * positive[1:]).sum(0)
    return c * t / torch.clamp(tau, min=1.0)


def posterior_summary(samples: torch.Tensor):
    """(mean, std, rhat, ess) over chains x draws, mean and std in natural
    space theta = exp(z)."""
    samples = torch.as_tensor(samples)
    flat = torch.exp(samples).reshape(-1, samples.shape[-1])
    return {
        "mean": flat.mean(0),
        "std": flat.std(0, correction=0),
        "rhat": split_rhat(samples),
        "ess": effective_sample_size(samples),
    }


# ---------------------------------------------------------------------------
# chain checkpoint / resume (hmc.py:765-841); the npz keys are JAX's
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_chain_checkpoint(path: str, result: HMCResult, states: Optional[ChainState] = None) -> None:
    """The adapted kernel and the draws (and the final chain states) as one npz."""
    payload = {
        "samples": _np(result.samples),
        "accept_rate": _np(result.accept_rate),
        "step_size": _np(result.step_size),
        "inv_mass": _np(result.inv_mass),
    }
    if states is not None:
        payload["state_z"] = _np(states.z)
        payload["state_logp"] = _np(states.logp)
        payload["state_grad"] = _np(states.grad)
    np.savez(path, **payload)


def load_chain_checkpoint(path: str, device=None):
    """(HMCResult, ChainState or None) from :func:`save_chain_checkpoint`
    (or JAX's), on ``device`` (utils/config.py: the card unless told)."""
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}

    def t(k):
        return config.as_input(arrays[k], device)

    result = HMCResult(samples=t("samples"), accept_rate=t("accept_rate"),
                       step_size=t("step_size"), inv_mass=t("inv_mass"))
    states = None
    if "state_z" in arrays:
        states = ChainState(z=t("state_z"), logp=t("state_logp"), grad=t("state_grad"))
    return result, states


def resume_hmc(logp_fn: Callable, checkpoint_path: str, generator, num_samples: int,
               cfg: HMCConfig = HMCConfig(), device=None) -> HMCResult:
    """Continue sampling from a checkpoint without warming up again: the
    adapted step size and mass, the chains restarted from their stored
    states (or their last stored draws)."""
    prev, states = load_chain_checkpoint(checkpoint_path, device)
    if states is None:
        states = init_chains(logp_fn, prev.samples[:, -1, :])
    gen = _generator(generator, states.z.device)
    logp_grad_fn = _value_and_grad(logp_fn)

    def transition(s, g, eps, im):
        return _hmc_transition(logp_grad_fn, s, g, eps, im, cfg)

    _, zs, accepts = _sample_loop(transition, states, gen, prev.step_size, prev.inv_mass,
                                  num_samples)
    return _result(HMCResult, zs, accepts, prev.step_size, prev.inv_mass)
