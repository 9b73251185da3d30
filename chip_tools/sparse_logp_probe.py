#!/usr/bin/env python3
"""The sparse log posterior's float32 error on one CUDA card, by route:
value and gradient of 16 chains (lengthscales 0.6-0.85, scales 0.61-1.28,
chip_smoke.py phase 28 (c)'s well-conditioned grid) at bench_sparse's data
(d=8, q=4, sigma 0.3, jitter 1e-4, m=512), against chip_smoke's plain
float64 sparse GP, beside the plain float32 one.  Routes: ``fleet-crout``
(K7 on the diagonal blocks), the same sweep with ``GPR_FLEET_DIAG=xla``
(torch's Cholesky on the diagonal blocks) and ``torch-cholesky``; then, on
``fleet-crout``, the chains' cross products Kmn Knm by row blocks (the
port's ``hmc._cross_products``), as one batched GEMM over all n rows, and
one chain a call.

    python3 chip_tools/sparse_logp_probe.py [n ...]
"""

import math
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import chip_smoke as cs
    import gpr_tpu_torch as tg
    from gpr_tpu_torch.inference import hmc as thmc
    from gpr_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    _cuda.build()
    _cuda.library()
    sig, jit, mc = 0.3, 1e-4, 512
    za, zb = np.linspace(math.log(0.6), math.log(0.85), 4), np.linspace(-0.5, 0.25, 4)
    ga, gb = np.meshgrid(za, zb, indexing="ij")
    z = torch.tensor(np.stack([ga.ravel(), gb.ravel()], 1), dtype=torch.float32, device=dev)
    for n in [int(a) for a in sys.argv[1:]] or [4096, 16384]:
        rng = np.random.default_rng(0)
        X64 = torch.tensor(rng.standard_normal((n, 8)), device=dev)
        Y64 = torch.tensor(rng.standard_normal((n, 4)), device=dev)
        Z64 = X64[:: n // mc][:mc].contiguous()
        X, Y, Z = X64.float(), Y64.float(), Z64.float()

        def plain(zz, Zp, Xp, Yp):
            vals, grads = [], []
            for zc in zz.to(Xp.dtype):
                zc = zc.detach().clone().requires_grad_()
                with torch.enable_grad():
                    th = torch.exp(zc)
                    val = cs.plain_sparse(Zp, Xp, Yp, th[0], th[1], sig, jit)["scalar"] + zc.sum()
                    (g,) = torch.autograd.grad(val, zc)
                vals.append(val.detach())
                grads.append(g)
            return torch.stack(vals), torch.stack(grads)

        v64, g64 = plain(z.double(), Z64, X64, Y64)
        v32, g32 = plain(z, Z, X, Y)
        print(f"n={n}: plain f32 value {cs.relerr(v32, v64):.3g} gradient {cs.relerr(g32, g64):.3g}; "
              f"max |g64| {float(g64.abs().max()):.4g}")
        blocks = thmc._cross_products
        variants = (("fleet-crout", None, {}, blocks, False),
                    ("fleet-crout, diag xla", None, {"GPR_FLEET_DIAG": "xla"}, blocks, False),
                    ("torch-cholesky", False, {}, blocks, False),
                    ("fleet-crout, one batched GEMM", None, {}, lambda K: K.mT @ K, False),
                    ("fleet-crout, one chain a call", None, {}, blocks, True))
        for name, uc, env, cross, single in variants:
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            thmc._cross_products = cross
            try:
                lp = thmc.make_sparse_gp_log_posterior(tg.Gaussian(1.0, 1.0), Z, X, Y, sig, jitter=jit,
                                                       use_crout=uc)
                vg = thmc._value_and_grad(lp)
                if single:
                    v, g = (torch.cat(t) for t in zip(*(vg(z[i:i + 1]) for i in range(z.shape[0]))))
                else:
                    v, g = vg(z)
                lp64 = thmc.make_sparse_gp_log_posterior(tg.Gaussian(1.0, 1.0), Z64, X64, Y64, sig,
                                                         jitter=jit, use_crout=uc)
                v6, g6 = thmc._value_and_grad(lp64)(z.double())
            finally:
                thmc._cross_products = blocks
                for k, val in old.items():
                    if val is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = val
            err = (g.double() - g64).abs()
            print(f"  {name} ({lp.route}): value {cs.relerr(v, v64):.3g} gradient {cs.relerr(g, g64):.3g}; "
                  f"float64 on the route: value {cs.relerr(v6, v64):.3g} gradient {cs.relerr(g6, g64):.3g}; "
                  f"per chain max |dg| {np.round(err.max(1).values.cpu().numpy(), 4).tolist()}, "
                  f"worst entry {np.unravel_index(int(err.argmax()), err.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
