"""One rank of the port's multi-process tests on the CPU (gloo).

    python tests/torch_dist_worker.py <suite> <world size> <rank> <run dir>

joins a gloo group through a ``FileStore`` in <run dir> (by
``sharded_hmc.initialize_distributed`` with a ``file://`` address), runs every case of
<suite> ("parallel" or "sharded_hmc") with one intra-op thread and writes
its results to <run dir>/rank<rank>.npz.  :func:`launch_worlds` starts the
ranks and reads their results back.  Imports torch, numpy and the port only; the
tests import the input recipes from here, so both sides see the same data.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# inputs, made from seeds with numpy
# ---------------------------------------------------------------------------

def spd(n, seed):
    G = np.random.default_rng(seed).standard_normal((n, n))
    return G @ G.T + n * np.eye(n)


def gram_inputs():
    return np.random.default_rng(0).standard_normal((64, 3))  # Gaussian(1.5, 1.0)


def solve_inputs():
    return np.linalg.cholesky(spd(64, 1)), np.random.default_rng(2).standard_normal((64, 3))


def safe_inputs():
    """K for the escalation: healthy; zeros (the first jitter factors it);
    rank 59 shifted to a smallest eigenvalue of -3e-13 (three tries, as
    tests/test_torch_linalg.py::_singular); -I, which never factors."""
    G = np.random.default_rng(6).standard_normal((64, 59))
    return {"healthy": spd(64, 3), "zeros": np.zeros((64, 64)),
            "singular": G @ G.T - 3e-13 * np.eye(64), "negative": -np.eye(64)}


def fit_inputs():
    rng = np.random.default_rng(9)
    X = rng.standard_normal((256, 3))
    return X, np.sin(X.sum(1, keepdims=True)) + 0.1 * rng.standard_normal((256, 2))  # Gaussian(1.1, 0.8), 0.2


def fleet_inputs():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((8, 32, 3))
    Y = np.sin(X.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((8, 32, 2))
    return X, Y, np.linspace(0.05, 0.5, 8), np.linspace(0.6, 2.0, 8), np.linspace(0.8, 1.5, 8)


def predictive_inputs():
    rng = np.random.default_rng(5)
    X = np.linspace(0.0, 6.0, 32)[:, None]
    Y = np.sin(X) + 0.1 * rng.standard_normal((32, 1))
    theta = np.exp(rng.normal(0.0, 0.3, (8, 2)))
    return theta, X, Y, np.linspace(-0.5, 6.5, 16)[:, None]  # Gaussian, sigma 0.1


def sampler_cases():
    """(name, sampler, z0, seed, config, chunk) of the bit-for-bit cases, as
    tests/test_sharded.py:157-247 runs JAX's."""
    return [
        ("hmc", "hmc", np.random.default_rng(0).standard_normal((8, 2)), 1,
         dict(num_warmup=60, num_samples=40, num_leapfrog=8), 16),
        ("hmc_windowed", "hmc", np.random.default_rng(3).standard_normal((16, 3)), 4,
         dict(num_warmup=45, num_samples=23, num_leapfrog=4, windowed_warmup=True), 10),
        ("nuts", "nuts", np.random.default_rng(7).standard_normal((8, 2)), 8,
         dict(num_warmup=30, num_samples=17, max_depth=4), 7),
    ]


def gp_posterior_data():
    """tests/test_torch_hmc.py::_small_gp's data: 32 points, priors LogGaussian(0, 1)."""
    rng = np.random.default_rng(21)
    X = np.linspace(0, 10, 32)[:, None]
    return X, np.sin(X) + 0.1 * rng.standard_normal((32, 1))


def moment_inputs(rank):
    rng = np.random.default_rng(10 + rank)
    return rng.standard_normal(3), rng.uniform(0.5, 2.0, 3)


NUTS_SCALES = (0.1, 5.0)  # tests/test_sharded.py:281-299's anisotropic Gaussian


def standard_normal_logp(z):
    return -0.5 * (z * z).sum(-1)


# ---------------------------------------------------------------------------
# the suites
# ---------------------------------------------------------------------------

def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def run_parallel(world, rank):
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.gp import batched
    from gpr_tpu_torch.inference import predictive
    from gpr_tpu_torch.parallel import sharded_gram as sg

    def t(a):
        return torch.tensor(a, dtype=torch.float64)

    mesh = sg.default_mesh(world, device="cpu")
    out = {}
    out["gram"] = sg.sharded_gram(tg.Gaussian(1.5, 1.0), t(gram_inputs()), mesh).numpy()
    A = spd(128, 0)
    nb = 128 // world
    A_rows = t(A[rank * nb:(rank + 1) * nb])  # the rank's rows
    out["chol"] = sg.cholesky_sharded(A_rows, mesh).numpy()
    kept = [np.array_equal(A_rows.numpy(), A[rank * nb:(rank + 1) * nb])]
    L, B = solve_inputs()
    out["solve"] = sg.cho_solve_sharded(t(L), t(B), mesh).numpy()  # all of L
    X, Y = fit_inputs()
    alpha, logdet, Lf = sg.fit_sharded(tg.Gaussian(1.1, 0.8), t(X), t(Y), 0.2, mesh)
    out.update(fit_alpha=alpha.numpy(), fit_logdet=logdet.numpy(), fit_L=Lf.numpy())
    for name, K in safe_inputs().items():
        Kt = t(K)
        Ls, j = sg.safe_cholesky_sharded(Kt, mesh)
        out[f"safe_{name}_L"], out[f"safe_{name}_jitter"] = Ls.numpy(), j.numpy()
        kept.append(np.array_equal(Kt.numpy(), K))
    out["inputs_kept"] = np.array(kept)
    whole = sg._GRAM_CHUNK
    try:  # the Gram in runs of 5 rows, the fit's in runs of 24: runs that do not divide a block row
        sg._GRAM_CHUNK = 5 * 64
        out["gram_runs"] = sg.sharded_gram(tg.Gaussian(1.5, 1.0), t(gram_inputs()), mesh).numpy()
        sg._GRAM_CHUNK = 24 * 256
        alpha, logdet, Lf = sg.fit_sharded(tg.Gaussian(1.1, 0.8), t(X), t(Y), 0.2, mesh)
        out.update(fit_runs_alpha=alpha.numpy(), fit_runs_logdet=logdet.numpy(), fit_runs_L=Lf.numpy())
    finally:
        sg._GRAM_CHUNK = whole

    Xf, Yf, sig, ls, sc = fleet_inputs()
    fmesh = sg.default_mesh(world, "fleet", device="cpu")
    for name, kern, bk, crout in (("fleet", tg.Gaussian(1.2, 0.9), False, None),
                                  ("fleet_crout", tg.Gaussian(1.2, 0.9), False, True),
                                  ("fleet_bk", tg.Gaussian(t(ls), t(sc)), True, None)):
        gp = batched.fit_batched_sharded(kern, t(Xf), t(Yf), t(sig), mesh=fmesh, batched_kernel=bk,
                                         use_crout=crout)
        out[f"{name}_alpha"], out[f"{name}_L"] = gp.alpha.numpy(), gp.L.numpy()
        out[f"{name}_route"] = np.array(gp.route)
    theta, Xp, Yp, Xs = predictive_inputs()
    pmesh = sg.default_mesh(world, "draws", device="cpu")
    res = predictive.predictive_sharded(tg.Gaussian(1.0, 1.0), t(theta), t(Xp), t(Yp), t(Xs), 0.1, mesh=pmesh)
    out.update(pred_mean=res.mean.numpy(), pred_var=res.variance.numpy(),
               pred_mpd=res.mean_per_draw.numpy(), pred_vpd=res.variance_per_draw.numpy())

    odd = 4 * (world // 2) + 1  # divisible by neither 2 nor 4
    k = tg.Gaussian(1.0, 1.0)
    Xo = t(np.zeros((odd, 2)))
    out["raises"] = np.array([
        _raises(lambda: sg.sharded_gram(k, Xo, mesh)),
        _raises(lambda: sg.fit_sharded(k, Xo, t(np.zeros(odd)), 0.1, mesh)),
        _raises(lambda: batched.fit_batched_sharded(k, t(np.resize(Xf, (odd, 32, 3))), t(np.resize(Yf, (odd, 32, 2))),
                                                    0.1, mesh=fmesh)),
        _raises(lambda: predictive.predictive_sharded(k, t(np.resize(theta, (odd, 2))), t(Xp), t(Yp), t(Xs), 0.1,
                                                      mesh=pmesh)),
    ])
    return out


def run_sharded_hmc(world, rank, inputs):
    import torch

    from gpr_tpu_torch import parallel
    from gpr_tpu_torch.inference import hmc, nuts, priors
    from gpr_tpu_torch.parallel import sharded_hmc as sh

    mesh = sh.default_mesh(world, device="cpu")
    out = {}
    for name, kind, z0, seed, cfg, chunk in sampler_cases():
        z0 = torch.tensor(z0)
        if kind == "hmc":
            res = sh.sample_hmc_sharded_chunked(standard_normal_logp, z0, seed, hmc.HMCConfig(**cfg),
                                                chunk_size=chunk, mesh=mesh)
        else:
            res = sh.sample_nuts_sharded_chunked(standard_normal_logp, z0, seed, nuts.NUTSConfig(**cfg),
                                                 chunk_size=chunk, mesh=mesh)
        for k in res._fields:
            out[f"{name}_{k}"] = res._asdict()[k].numpy()

    X, Y = gp_posterior_data()
    logp = hmc.make_gp_log_posterior(hmc.kermod.Gaussian(1.0, 1.0), X, Y, 0.1,
                                     [priors.LogGaussianDensity(0.0, 1.0)] * 2, device="cpu")
    res = sh.sample_hmc_sharded(logp, torch.tensor(inputs["gp_z0"]), 3,
                                hmc.HMCConfig(num_warmup=60, num_samples=100, num_leapfrog=4), mesh=mesh)
    out.update(gp_samples=res.samples.numpy(), gp_accept=res.accept_rate.numpy(),
               gp_step_size=res.step_size.numpy(), gp_inv_mass=res.inv_mass.numpy())

    scales = torch.tensor(NUTS_SCALES)
    cfg = nuts.NUTSConfig(num_warmup=150, num_samples=100, max_depth=6, windowed_warmup=True)
    res = sh.sample_hmc_sharded(lambda z: -0.5 * ((z / scales) ** 2).sum(-1), torch.zeros((16, 2), dtype=torch.float64),
                                1, cfg, mesh=mesh, sampler=nuts.sample_nuts)
    out.update(nuts_sharded_samples=res.samples.numpy(), nuts_sharded_inv_mass=res.inv_mass.numpy())

    m, v = moment_inputs(rank)
    g_mean, g_var, w = sh._pmoments(torch.tensor(m), torch.tensor(v), 50, sh.sharded_gram._Axis(mesh, "chains"))
    out.update(mom_mean=g_mean.numpy(), mom_var=g_var.numpy(), mom_w=np.array(w))

    z7 = torch.zeros((4 * (world // 2) + 1, 2), dtype=torch.float64)
    out["raises"] = np.array([
        _raises(lambda: sh.sample_hmc_sharded_chunked(standard_normal_logp, z7, 0, mesh=mesh)),
        _raises(lambda: sh.sample_nuts_sharded_chunked(standard_normal_logp, z7, 0, mesh=mesh)),
        _raises(lambda: sh.sample_hmc_sharded(standard_normal_logp, z7, 0, mesh=mesh)),
    ])
    for k, v in parallel.dryrun_multichip(world, device="cpu").items():
        out[f"dryrun_{k}"] = np.array(v)
    return out


def main(argv):
    suite, world, rank, run_dir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    import torch
    import torch.distributed as dist

    from gpr_tpu_torch.parallel import sharded_hmc

    torch.set_num_threads(1)
    sharded_hmc.initialize_distributed(f"file://{(run_dir / 'store').resolve()}", num_processes=world,
                                       process_id=rank)
    try:
        if suite == "parallel":
            out = run_parallel(world, rank)
        else:
            with np.load(run_dir / "inputs.npz") as f:
                out = run_sharded_hmc(world, rank, dict(f))
        np.savez(run_dir / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


def launch_worlds(suite, worlds, run_dir, timeout=240, inputs=None):
    """Start ``suite`` at each world size of ``worlds`` at once, each world's
    ranks in a directory of its own under ``run_dir``; returns {world size:
    each rank's results in rank order}.  Raises with a rank's output if one
    fails, and leaves no process running."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = {}
    try:
        for world in worlds:
            wdir = Path(run_dir) / f"world{world}"
            wdir.mkdir(parents=True, exist_ok=True)
            if inputs is not None:
                np.savez(wdir / "inputs.npz", **inputs)
            for r in range(world):
                procs[world, r] = subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), suite, str(world), str(r), str(wdir)],
                    cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        outs = {key: p.communicate(timeout=timeout)[0] for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for (world, r), p in procs.items():
        if p.returncode:
            raise RuntimeError(f"rank {r} of {world} ({suite}) exited {p.returncode}:\n{outs[world, r][-4000:]}")
    results = {}
    for world in worlds:
        results[world] = []
        for r in range(world):
            with np.load(Path(run_dir) / f"world{world}" / f"rank{r}.npz") as f:
                results[world].append({k: f[k] for k in f.files})
    return results


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
