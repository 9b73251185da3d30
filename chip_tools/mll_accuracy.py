#!/usr/bin/env python3
"""Where the float32 error of the marginal likelihood's gradient comes from,
on one CUDA card: Gaussian(8, 1), d=128, q=8, sigma 0.1 at n = 16384
(route fused-matrix), 16383 (blocked-syrk) and 8192.

    python3 chip_tools/mll_accuracy.py

For each n it prints the relative error against a float64 plain MLL of the
value and the gradient from: the plain float32 route (torch.linalg.cholesky
+ autograd); the port (gpr_tpu_torch.gp.likelihood.mll_value_and_grad); and
the port with cuSOLVER's factor in place of its route's (same Murray
backward).  Then the relative error of each route's factor against the
float64 factor.
"""

import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
LDBL_LOG_MAX = 11356.523406294143


def main() -> int:
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.gp import likelihood as lk
    from gpr_tpu_torch.ops import linalg

    dev = torch.device("cuda")
    n, d, q = 16384, 128, 8
    rng0 = np.random.default_rng(0)
    Xb = torch.tensor(rng0.standard_normal((n, d)), dtype=torch.float32, device=dev)
    Yb = torch.tensor(rng0.standard_normal((n, q)), dtype=torch.float32, device=dev)
    sig = float(np.float32(0.1))
    kernel = tg.Gaussian(8.0, 1.0)

    def gram(A, sigma, scale):
        d2 = (A * A).sum(1)[:, None] + (A * A).sum(1)[None, :] - 2.0 * (A @ A.T)
        return scale * scale * torch.exp(-0.5 * d2.clamp(min=0.0) / (sigma * sigma))

    def plain_mll(X, Y):
        m = X.shape[0]
        p = torch.tensor([8.0, 1.0], dtype=torch.float64, device=dev, requires_grad=True)
        K = gram(X, p[0], p[1])
        K = K + torch.diag(torch.full((m,), sig * sig, dtype=K.dtype, device=dev))
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(Y, L)
        df = -0.5 * (Y * alpha).sum(0)
        cp = -0.5 * torch.clamp(2.0 * torch.log(torch.diagonal(L)).sum(), -LDBL_LOG_MAX,
                                LDBL_LOG_MAX)
        ct = -m / 2.0 * math.log(2 * math.pi)
        (g,) = torch.autograd.grad(df.sum() + cp + ct, p)
        return (df + cp + ct).detach(), g

    def rel(a, b):
        a, b = a.double().to(b.device), b.double()
        return float((a - b).abs().max() / b.abs().max())

    for m in (16384, 16383, 8192):
        X, Y = Xb[:m], Yb[:m]
        v64, g64 = plain_mll(X.double(), Y.double())
        v32, g32 = plain_mll(X, Y)
        vp, gp = lk.mll_value_and_grad(kernel, X, Y, 0.1)
        route = lk.factor_route(X)
        saved = linalg._FACTOR[route]
        linalg._FACTOR[route] = linalg._torch_cholesky
        try:
            vc, gc = lk.mll_value_and_grad(kernel, X, Y, 0.1)
        finally:
            linalg._FACTOR[route] = saved
        print(f"n={m} ({route}): rel err vs f64 (value, gradient): plain f32 "
              f"{rel(v32, v64):.3g}, {rel(g32, g64):.3g}; port {rel(vp, v64):.3g}, "
              f"{rel(gp, g64):.3g}; port with cuSOLVER's factor {rel(vc, v64):.3g}, "
              f"{rel(gc, g64):.3g}", flush=True)
        K = gram(X, 8.0, 1.0)
        K.diagonal().add_(sig * sig)
        L64 = torch.linalg.cholesky(K.double())
        print(f"  factor rel err vs f64: cuSOLVER {rel(torch.linalg.cholesky(K), L64):.3g}, "
              f"{route} {rel(linalg._FACTOR[route](K), L64):.3g}", flush=True)
        del K, L64
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
