"""No-U-Turn Sampler, iterative, all chains as one batch.

Mirrors gpr_tpu/inference/nuts.py:36-411 (``NUTSConfig``,
``_build_subtree``, ``_nuts_transition``, ``NUTSResult``, ``sample_nuts``,
``sample_nuts_chunked``), the adaptive-trajectory companion of
``inference.hmc``; the warmup is ``hmc._adapt_phase`` with this transition.

The recursive tree build is iterative: an outer loop over the depth
doublings, an inner loop over the 2^d leapfrog steps of each subtree; the
balanced subtrees' U-turn checks by the trailing-zeros trick (leaf m stores
its (z, p) at every stack level j with 2^j | m, and after leaf i every level
with 2^j | (i + 1) compares against its stored start); progressive
multinomial sampling inside a subtree, biased trajectory sampling across
doublings, a divergence at dH < -1000.

JAX's loop is static: every transition integrates 2^max_depth - 1 leaves.
The port stops a subtree once no chain of the batch is still building a
live trajectory, and the transition once no chain is going on: a chain
whose trajectory or subtree has turned or diverged freezes every
accumulator the transition uses (nuts.py:104-110), so the leaves left out
change nothing.  That costs the host one read a leaf.

A transition splits into its draws (:func:`_nuts_draws`: the momentum, a
direction per depth, a uniform per leaf and a swap uniform per depth, all
drawn up front, so the stream does not depend on where the trees stop) and
a deterministic step (:func:`_nuts_step`).

With ``shard_ctx`` (an ``hmc.ShardCtx``) ``sample_nuts_chunked`` runs the
rank's block of the chains as ``hmc.sample_hmc_chunked`` does, equal to the
single-process run bit for bit (nuts.py:309-411): each transition draws for
all chains and keeps the rank's rows.  A rank's trees stop where its own
chains stop, which changes no chain's result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from . import hmc
from .hmc import ChainState, ShardCtx


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    num_warmup: int = 500
    num_samples: int = 500
    max_depth: int = 8
    target_accept: float = 0.8
    initial_step_size: float = 0.1
    max_step_size: float = 10.0
    divergence_threshold: float = 1000.0
    windowed_warmup: bool = False  # Stan-style expanding windows (see hmc)


class NUTSDraws(NamedTuple):
    """One transition's randomness: momentum noise (chains, dim), the
    direction +-1 of each depth (chains, max_depth), a uniform per leaf in
    depth order (chains, 2^max_depth - 1), a swap uniform per depth
    (chains, max_depth)."""

    normal: torch.Tensor
    direction: torch.Tensor
    u_leaf: torch.Tensor
    u_swap: torch.Tensor


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (chains, T, dim) log space
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    inv_mass: torch.Tensor


def _kinetic(p, inv_mass):
    return 0.5 * (inv_mass * p * p).sum(-1)


def _logaddexp(a, b):
    # jax.lax.logaddexp's formula (a NaN difference: infinities of one sign)
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(delta))))


def _build_subtree(logp_grad_fn, z0, p0, g0, direction, depth: int, eps, inv_mass, H0, u_leaf,
                   cfg, going=None):
    """Integrate 2^depth steps of every chain from (z0, p0) in its
    ``direction``; returns the subtree's summary (nuts.py:84-164).
    ``u_leaf`` (chains, 2^depth) are the leaves' uniforms.  With ``going``
    (chains,) the loop ends once no chain that is going is still live."""
    C, dim = z0.shape
    levels = depth + 1
    dt, dev = z0.dtype, z0.device
    sz = torch.zeros((C, levels, dim), dtype=dt, device=dev)
    sp = torch.zeros_like(sz)
    z, p, g = z0, p0, g0
    lp = torch.zeros(C, dtype=dt, device=dev)
    lsw = torch.full((C,), -torch.inf, dtype=dt, device=dev)
    prop = (z0, torch.full((C,), -torch.inf, dtype=dt, device=dev), g0)
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverged = torch.zeros_like(turning)
    acc = torch.zeros(C, dtype=dt, device=dev)
    nl = torch.zeros_like(acc)
    step = (direction * eps)[:, None]
    for i in range(2**depth):
        live = ~(turning | diverged)
        if going is not None and i and not bool((going & live).any()):
            break
        p = p + 0.5 * step * g
        z = z + step * inv_mass * p
        lp, g = logp_grad_fn(z)
        p = p + 0.5 * step * g
        dH = (lp - _kinetic(p, inv_mass)) - H0
        dH = torch.where(torch.isnan(dH), -torch.inf, dH)
        div_now = dH < -cfg.divergence_threshold
        # only leaves of the live trajectory count in the accept statistic
        acc = acc + torch.where(live, torch.clamp(torch.exp(dH), max=1.0), 0.0)
        nl = nl + torch.where(live, 1.0, 0.0)

        # leaf i goes to every stack level j with 2^j | i
        store = [j for j in range(levels) if i % 2**j == 0]
        sz[:, store] = z[:, None, :]
        sp[:, store] = p[:, None, :]
        # the balanced subtrees completed by leaf i: levels j >= 1, 2^j | (i + 1)
        complete = [j for j in range(1, levels) if (i + 1) % 2**j == 0]
        turning_now = torch.zeros_like(turning)
        if complete:
            dz = direction[:, None, None] * (z[:, None, :] - sz[:, complete])
            turn_j = (((dz * (inv_mass * sp[:, complete])).sum(-1) < 0)
                      | ((dz * (inv_mass * p[:, None, :])).sum(-1) < 0))
            turning_now = turn_j.any(-1)

        # progressive multinomial sampling within the subtree
        lsw_new = _logaddexp(lsw, dH)
        take = u_leaf[:, i] < torch.exp(dH - lsw_new)
        prop = (torch.where(take[:, None], z, prop[0]), torch.where(take, lp, prop[1]),
                torch.where(take[:, None], g, prop[2]))

        # every accumulator freezes once the subtree is invalid
        lsw = torch.where(live, lsw_new, lsw)
        turning = turning | (live & turning_now)
        diverged = diverged | (live & div_now)
    return z, p, g, lp, lsw, prop, turning, diverged, acc, nl


def _nuts_draws(generator: torch.Generator, state: ChainState, cfg: NUTSConfig,
                shard_ctx: Optional[ShardCtx] = None) -> NUTSDraws:
    """One transition's randomness; with ``shard_ctx``, all chains' drawn
    and the rank's rows kept."""
    z = state.z
    C = z.shape[0] if shard_ctx is None else shard_ctx.n_global
    D = cfg.max_depth

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=z.dtype, device=z.device)

    normal = torch.randn((C, z.shape[1]), generator=generator, dtype=z.dtype, device=z.device)
    direction = torch.where(rand(C, D) < 0.5, 1.0, -1.0).to(z.dtype)
    draws = NUTSDraws(normal, direction, rand(C, 2**D - 1), rand(C, D))
    return draws if shard_ctx is None else NUTSDraws(*(shard_ctx.local(d) for d in draws))


def _nuts_step(logp_grad_fn, state: ChainState, draws: NUTSDraws, eps, inv_mass, cfg: NUTSConfig,
               stop_early: bool = True):
    """The deterministic part of one NUTS transition of every chain
    (nuts.py:167-255).  Returns (state', accept_stat).  ``stop_early``
    leaves out the leaves and depths no chain uses."""
    z, lp0, g0 = state
    dt = z.dtype
    p0 = draws.normal / torch.sqrt(inv_mass)
    H0 = lp0 - _kinetic(p0, inv_mass)
    zm = zp = z_prop = z
    pm = pp = p0
    gm = gp = g_prop = g0
    lpm = lpp = lp_prop = lp0
    log_sum_w = torch.zeros_like(lp0)
    turning = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    diverged = torch.zeros_like(turning)
    sum_accept = torch.zeros_like(lp0)
    n_leaves = torch.zeros_like(lp0)

    first = 0
    for depth in range(cfg.max_depth):
        going = ~(turning | diverged)
        if stop_early and not bool(going.any()):
            break
        direction = draws.direction[:, depth].to(dt)
        fwd = direction > 0
        z0 = torch.where(fwd[:, None], zp, zm)
        p0_end = torch.where(fwd[:, None], pp, pm)
        g0_end = torch.where(fwd[:, None], gp, gm)
        u_leaf = draws.u_leaf[:, first:first + 2**depth]
        first += 2**depth
        z_e, p_e, g_e, lp_e, lsw_sub, prop, turn_sub, div_sub, acc, n_sub = _build_subtree(
            logp_grad_fn, z0, p0_end, g0_end, direction, depth, eps, inv_mass, H0, u_leaf, cfg,
            going if stop_early else None)

        # biased trajectory sampling: the subtree's proposal with prob
        # min(1, w_sub / w_old) when the subtree itself is valid
        upd = going & ~(turn_sub | div_sub)
        swap = upd & (draws.u_swap[:, depth] < torch.exp(lsw_sub - log_sum_w))
        z_prop = torch.where(swap[:, None], prop[0], z_prop)
        lp_prop = torch.where(swap, prop[1], lp_prop)
        g_prop = torch.where(swap[:, None], prop[2], g_prop)

        # extend the moved endpoint
        f, b = (upd & fwd)[:, None], (upd & ~fwd)[:, None]
        zp, pp, gp = torch.where(f, z_e, zp), torch.where(f, p_e, pp), torch.where(f, g_e, gp)
        lpp = torch.where(f[:, 0], lp_e, lpp)
        zm, pm, gm = torch.where(b, z_e, zm), torch.where(b, p_e, pm), torch.where(b, g_e, gm)
        lpm = torch.where(b[:, 0], lp_e, lpm)

        # the U-turn across the whole trajectory
        dz = zp - zm
        turn_all = ((dz * (inv_mass * pm)).sum(-1) < 0) | ((dz * (inv_mass * pp)).sum(-1) < 0)

        log_sum_w = torch.where(upd, _logaddexp(log_sum_w, lsw_sub), log_sum_w)
        turning = turning | (going & (turn_sub | turn_all))
        diverged = diverged | (going & div_sub)
        sum_accept = sum_accept + torch.where(going, acc, 0.0)
        n_leaves = n_leaves + torch.where(going, n_sub, 0.0)

    accept_stat = sum_accept / torch.clamp(n_leaves, min=1.0)
    return ChainState(z=z_prop, logp=lp_prop, grad=g_prop), accept_stat


def _nuts_transition(logp_grad_fn, state: ChainState, generator, eps, inv_mass, cfg: NUTSConfig,
                     shard_ctx: Optional[ShardCtx] = None):
    """One NUTS update of every chain (of the rank's); returns (state',
    accept_stat)."""
    return _nuts_step(logp_grad_fn, state, _nuts_draws(generator, state, cfg, shard_ctx), eps,
                      inv_mass, cfg)


def _setup(logp_fn, z0, generator, cfg, cross_chain_mean, cross_chain_moments, device,
           shard_ctx: Optional[ShardCtx] = None):
    z0 = hmc._chains(z0, device)
    gen = hmc._generator(generator, z0.device)
    logp_grad_fn = hmc._value_and_grad(logp_fn)
    states = hmc.init_chains(logp_fn, hmc._sharded_chains(z0, shard_ctx))

    def transition(s, g, e, im):
        return _nuts_transition(logp_grad_fn, s, g, e, im, cfg, shard_ctx)

    # the warmup is hmc's single implementation, with this transition
    states, eps2, inv_mass = hmc._adapt_phase(logp_grad_fn, states, gen, cfg, z0.shape[1],
                                              z0.dtype, cross_chain_mean, cross_chain_moments,
                                              transition=transition, shard_ctx=shard_ctx)
    return transition, states, gen, eps2, inv_mass


def sample_nuts(logp_fn: Callable, z0, generator, cfg: NUTSConfig = NUTSConfig(),
                cross_chain_mean: Optional[Callable] = None,
                cross_chain_moments: Optional[Callable] = None, device=None) -> NUTSResult:
    """NUTS chains from z0 (chains, dim) with :func:`hmc.sample_hmc`'s warmup
    (nuts.py:265-306); ``generator`` a ``torch.Generator`` on the chains'
    device or an int seed."""
    transition, states, gen, eps2, inv_mass = _setup(logp_fn, z0, generator, cfg,
                                                     cross_chain_mean, cross_chain_moments, device)
    _, zs, accepts = hmc._sample_loop(transition, states, gen, eps2, inv_mass, cfg.num_samples)
    return hmc._result(NUTSResult, zs, accepts, eps2, inv_mass)


def sample_nuts_chunked(logp_fn: Callable, z0, generator, cfg: NUTSConfig = NUTSConfig(),
                        chunk_size: int = 16, cross_chain_mean: Optional[Callable] = None,
                        cross_chain_moments: Optional[Callable] = None,
                        shard_ctx: Optional[ShardCtx] = None, device=None) -> NUTSResult:
    """:func:`sample_nuts` with the sampling stage in chunks of ``chunk_size``
    transitions (nuts.py:309-411): the same draws bit for bit, as
    ``hmc.sample_hmc_chunked`` is to ``sample_hmc`` (JAX's chunk programs
    are its remote-backend compile-time workaround).  ``shard_ctx`` as in
    ``hmc.sample_hmc_chunked``: all chains in, all chains out."""
    chunk_size = hmc._chunk_size(chunk_size, cfg.num_samples)
    transition, states, gen, eps2, inv_mass = _setup(logp_fn, z0, generator, cfg,
                                                     cross_chain_mean, cross_chain_moments, device,
                                                     shard_ctx)
    zs, accepts = hmc._chunked(transition, states, gen, eps2, inv_mass, cfg.num_samples,
                               chunk_size)
    return hmc._result(NUTSResult, *hmc._gathered(zs, accepts, shard_ctx), eps2, inv_mass)
