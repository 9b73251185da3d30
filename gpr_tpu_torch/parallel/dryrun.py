"""One training step of every multi-rank path, at tiny shapes.

Mirrors ``dryrun_multichip`` of the repository root's __graft_entry__.py
(:55-230): on a 2-D mesh (chains x data) over the world's ranks, the fit with
the rows of K split over "data", then one HMC transition with the chains
split over "chains" and the accept statistic averaged over "chains"; the
sharded fit at n=1024 against the one-process ``gp.exact.fit``; the sharded
chunked HMC and NUTS on a 1-D mesh, NUTS bit for bit the one-process run;
the fleet split over the ranks.  Every rank runs it; ``n_devices`` must be
the world's size (1 starts a world of one).
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPE = torch.float32


def _make_dataset(n: int, d: int, q: int, device):
    """X (n, d), Y (n, q) of __graft_entry__.py:20-25, float32."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((n, q))
    return (torch.tensor(X, device=device),
            torch.tensor(Y.astype(np.float32), device=device))


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the step on ``n_devices`` ranks (the card unless ``device`` says
    otherwise); raises on a non-finite or disagreeing result.  Returns the
    checked errors."""
    from .. import Gaussian, Sum, White
    from ..gp import batched as fleet_mod
    from ..gp import exact as exact_mod
    from ..inference import hmc as hmc_mod
    from ..inference import nuts as nuts_mod
    from . import sharded_gram as sg
    from . import sharded_hmc as sh

    data_ax = 2 if n_devices % 2 == 0 else 1
    chain_ax = n_devices // data_ax
    mesh = sg.make_mesh((chain_ax, data_ax), ("chains", "data"), device)
    dev = sg.mesh_device(mesh)

    n, d, q = 8 * data_ax, 4, 2
    X, Y = _make_dataset(n, d, q, dev)
    kernel = Sum(Gaussian(torch.tensor(1.5, dtype=_DTYPE), torch.tensor(1.0, dtype=_DTYPE)),
                 White(torch.tensor(0.1, dtype=_DTYPE)))
    sigma = 0.1

    # the fit, rows over "data" (replicated over "chains")
    alpha, logdet, L = sg.fit_sharded(kernel, X, Y, sigma, mesh, "data")
    _check(bool(torch.isfinite(alpha).all()) and bool(torch.isfinite(logdet)), "fit_sharded not finite")

    # one HMC transition, chains over "chains", the accept statistic averaged there
    chains, dim = 2 * chain_ax, kernel.num_params
    logp = hmc_mod.make_gp_log_posterior(kernel, X, Y, sigma)
    ctx = hmc_mod.ShardCtx(mesh=mesh, axis="chains", n_global=chains)
    states = hmc_mod.init_chains(logp, ctx.local(torch.zeros((chains, dim), dtype=_DTYPE, device=dev)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = hmc_mod.HMCConfig(num_leapfrog=2, jitter_steps=False)
    new_states, accept = hmc_mod._hmc_transition(
        hmc_mod._value_and_grad(logp), states, gen, torch.tensor(0.05, dtype=_DTYPE, device=dev),
        torch.ones(dim, dtype=_DTYPE, device=dev), cfg, ctx)
    mean_accept = ctx.ax.mean(accept.mean())
    _check(bool(torch.isfinite(new_states.z).all()) and bool(torch.isfinite(mean_accept)),
           "the sharded HMC transition is not finite")

    # the sharded fit at n=1024 against the one-process fit
    n_big = 1024
    Xb, Yb = _make_dataset(n_big, d, q, dev)
    alpha_sh, logdet_sh, _ = sg.fit_sharded(kernel, Xb, Yb, sigma, mesh, "data")
    gp_ref = exact_mod.fit(kernel, Xb, Yb, sigma=sigma, use_pallas_gram=False)
    a_err = float((alpha_sh - gp_ref.alpha).abs().max()) / max(1.0, float(gp_ref.alpha.abs().max()))
    logdet_ref = float(2.0 * torch.log(gp_ref.L.diagonal()).sum())
    l_err = abs(float(logdet_sh) - logdet_ref) / max(1.0, abs(logdet_ref))
    _check(a_err < 5e-3, f"sharded alpha mismatch at n={n_big}: {a_err}")
    _check(l_err < 1e-4, f"sharded logdet mismatch at n={n_big}: {l_err}")

    # the chunked samplers on a 1-D chains mesh
    mesh1d = sg.default_mesh(n_devices, "chains", device)
    res = sh.sample_hmc_sharded_chunked(
        logp, torch.zeros((2 * n_devices, dim), dtype=_DTYPE, device=dev), 1,
        hmc_mod.HMCConfig(num_warmup=4, num_samples=4, num_leapfrog=2, jitter_steps=False),
        chunk_size=2, mesh=mesh1d)
    _check(bool(torch.isfinite(res.samples).all()), "sharded chunked HMC not finite")
    scales = torch.arange(1, dim + 1, dtype=_DTYPE, device=dev)

    def logp_aniso(z):
        return -0.5 * (scales * z * z).sum(-1)

    ncfg = nuts_mod.NUTSConfig(num_warmup=4, num_samples=4, max_depth=3)
    zn0 = torch.zeros((2 * n_devices, dim), dtype=_DTYPE, device=dev)
    res_sh = sh.sample_nuts_sharded_chunked(logp_aniso, zn0, 3, ncfg, chunk_size=2, mesh=mesh1d)
    res_1 = nuts_mod.sample_nuts_chunked(logp_aniso, zn0, 3, ncfg, chunk_size=2)
    _check(torch.equal(res_sh.samples, res_1.samples), "sharded chunked NUTS differs from one process")

    # the fleet, members over the ranks
    rngf = np.random.default_rng(2)
    Xf = torch.tensor(rngf.standard_normal((2 * n_devices, 16, dim)), dtype=_DTYPE, device=dev)
    Yf = torch.sin(Xf.sum(-1, keepdim=True))
    gp_f = fleet_mod.fit_batched_sharded(kernel, Xf, Yf, 0.1, mesh=mesh1d, axis="chains")
    _check(bool(torch.isfinite(gp_f.alpha).all()), "fit_batched_sharded not finite")
    return {"alpha_err": a_err, "logdet_err": l_err, "mean_accept": float(mean_accept)}
