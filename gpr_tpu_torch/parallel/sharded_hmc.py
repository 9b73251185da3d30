"""HMC and NUTS chains split over the ranks of a device mesh.

Mirrors gpr_tpu/parallel/sharded_hmc.py:1-222 (``default_mesh``,
``initialize_distributed``, ``sample_hmc_sharded``,
``sample_hmc_sharded_chunked``, ``sample_nuts_sharded_chunked``,
``chain_scaling_efficiency``) on ``torch.distributed``: a 1-D mesh
(dimension "chains") over the ranks, each running its block of the chains
as one fleet.

Two forms, as in JAX:

* :func:`sample_hmc_sharded` runs the sampler on each rank's chains with its
  own generator stream (JAX splits the key per device, sharded_hmc.py:107)
  and combines the warmup's statistics over all ranks: the accept statistic
  by an all-reduce mean, the mass from moments combined by JAX's formula
  (:func:`_pmoments`, sharded_hmc.py:81-87), so every rank adapts the same
  step size and mass.  The draws agree with a one-process run in
  distribution.
* :func:`sample_hmc_sharded_chunked` and :func:`sample_nuts_sharded_chunked`
  pass an ``hmc.ShardCtx`` to the chunked samplers, whose draws then equal
  the one-process chunked run's bit for bit, where the log density of a
  chain does not depend on how many chains share its call (see
  ``inference/hmc.py``).

Every rank passes all chains' z0 and the same generator seed, and gets the
whole result back, the samples gathered in chain order.  Each rank runs on
its mesh's device (the card ``LOCAL_RANK % device_count``, or the CPU).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..inference import hmc as hmc_mod
from . import sharded_gram


def default_mesh(n_devices: Optional[int] = None, axis: str = "chains", device=None):
    """A 1-D mesh over every rank, dimension ``axis`` (sharded_hmc.py:31-34)."""
    return sharded_gram.default_mesh(n_devices, axis, device)


def initialize_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join a multi-process run (sharded_hmc.py:37-44): a no-op for
    ``coordinator`` None.  Otherwise ``coordinator`` is "host:port" or an
    init URL (``tcp://``, ``file://``), and the rank and world size default
    to the ``RANK`` / ``WORLD_SIZE`` that ``torchrun`` sets.  The backend
    follows the device, as :func:`sharded_gram.default_mesh`'s does: NCCL
    where there is a card (each rank on the card ``LOCAL_RANK %
    device_count``), gloo otherwise."""
    if coordinator is None:
        return
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        sharded_gram.set_local_device()
    address = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(sharded_gram.backend_for(device_type), init_method=address, rank=rank, world_size=world)


def _pmoments(mean: torch.Tensor, var: torch.Tensor, w, ax) -> tuple:
    """Per-rank (mean, var, count) combined over the ranks
    (sharded_hmc.py:81-87): E[x] = pmean(mean), Var[x] = pmean(var + mean^2)
    - E[x]^2 floored at 1e-12, the count times the ranks."""
    g_mean = ax.mean(mean)
    g_var = ax.mean(var + mean**2) - g_mean**2
    return g_mean, torch.clamp(g_var, min=1e-12), w * ax.size


def _rank_generator(generator, device, ax) -> torch.Generator:
    """This rank's stream: seeds for every rank drawn from the shared
    generator, the rank's taken (JAX's ``random.split(key, n_dev)``)."""
    gen = hmc_mod._generator(generator, device)
    seeds = torch.randint(0, 2**62, (ax.size,), generator=gen, device=gen.device)
    own = torch.Generator(device=device)
    own.manual_seed(int(seeds[ax.rank]))
    return own


def _chains_for(z0, mesh, axis: str):
    ax = sharded_gram._Axis(mesh, axis)
    z0 = hmc_mod._chains(z0, sharded_gram.mesh_device(mesh))
    if z0.shape[0] % ax.size:
        raise ValueError(f"num_chains ({z0.shape[0]}) must be divisible by mesh size ({ax.size})")
    return z0, ax


def sample_hmc_sharded(logp_fn: Callable, z0, generator, cfg=None, mesh=None, axis: str = "chains",
                       sampler: Optional[Callable] = None, device=None) -> hmc_mod.HMCResult:
    """HMC (or, with ``sampler=nuts.sample_nuts`` and a ``NUTSConfig``, NUTS)
    with the chains split over ``mesh`` (sharded_hmc.py:47-140).  z0
    (chains, dim), chains divisible by the mesh size; ``generator`` a seed
    or a ``torch.Generator`` seeded alike on every rank."""
    if cfg is None:
        cfg = hmc_mod.HMCConfig()
    if sampler is None:
        sampler = hmc_mod.sample_hmc
    if mesh is None:
        mesh = default_mesh(axis=axis, device=device)
    z0, ax = _chains_for(z0, mesh, axis)
    nl = z0.shape[0] // ax.size
    res = sampler(logp_fn, z0[ax.rank * nl:(ax.rank + 1) * nl], _rank_generator(generator, z0.device, ax),
                  cfg, cross_chain_mean=ax.mean,
                  cross_chain_moments=lambda m, v, w: _pmoments(m, v, w, ax))
    return type(res)(samples=ax.gather(res.samples), accept_rate=ax.gather(res.accept_rate),
                     step_size=res.step_size, inv_mass=res.inv_mass)


def sample_hmc_sharded_chunked(logp_fn: Callable, z0, generator, cfg=None, chunk_size: int = 64,
                               mesh=None, axis: str = "chains", device=None) -> hmc_mod.HMCResult:
    """``hmc.sample_hmc_chunked`` with the chains split over ``mesh``
    (sharded_hmc.py:143-187): bit for bit the one-process run."""
    if cfg is None:
        cfg = hmc_mod.HMCConfig()
    if mesh is None:
        mesh = default_mesh(axis=axis, device=device)
    z0, _ = _chains_for(z0, mesh, axis)
    ctx = hmc_mod.ShardCtx(mesh=mesh, axis=axis, n_global=z0.shape[0])
    return hmc_mod.sample_hmc_chunked(logp_fn, z0, generator, cfg, chunk_size=chunk_size, shard_ctx=ctx)


def sample_nuts_sharded_chunked(logp_fn: Callable, z0, generator, cfg=None, chunk_size: int = 16,
                                mesh=None, axis: str = "chains", device=None):
    """``nuts.sample_nuts_chunked`` with the chains split over ``mesh``
    (sharded_hmc.py:190-211): bit for bit the one-process run."""
    from ..inference import nuts as nuts_mod

    if cfg is None:
        cfg = nuts_mod.NUTSConfig()
    if mesh is None:
        mesh = default_mesh(axis=axis, device=device)
    z0, _ = _chains_for(z0, mesh, axis)
    ctx = hmc_mod.ShardCtx(mesh=mesh, axis=axis, n_global=z0.shape[0])
    return nuts_mod.sample_nuts_chunked(logp_fn, z0, generator, cfg, chunk_size=chunk_size, shard_ctx=ctx)


def chain_scaling_efficiency(samples_per_sec: dict) -> dict:
    """{n_devices: samples/s} -> each n's share of linear scaling from one
    device (sharded_hmc.py:214-222)."""
    base = samples_per_sec.get(1)
    if base is None:
        return {}
    return {n: v / (base * n) for n, v in samples_per_sec.items() if n != 1}
