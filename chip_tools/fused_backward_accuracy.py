#!/usr/bin/env python3
"""Where the float32 error of the fused fleet's gradient comes from, on one
CUDA card.

    python3 chip_tools/fused_backward_accuracy.py

The fused fleet (route fleet-fused, K9) returns (L, alpha) and, as JAX's
factor_solve_fused_diff does, re-derives the diagonal-block inverses W of L
in its backward: W = the inverse factor of chol(D D^T), one K8 launch
(gpr_tpu/ops/pallas_batched.py:494-506).  For two fleets (B=4, n=256, d=3,
q=2, the card test's; and B=128, n=512, d=8, q=4, chip_smoke.py phase 9's,
per-member hyperparameters) it prints the relative error against the
float64 plain MLL of mll_batched's gradient with W taken four ways: the
panel sweep (fleet-crout, its own W), K8 on D D^T, a triangular solve of D
against I (the xla scheme), and the W that K9 computed in its forward; then
the relative error of each W against inv(D) in float64, and the plain
float32 route's gradient error.
"""

import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.gp import batched as fleet
    from gpr_tpu_torch.ops import batched as fops
    from gpr_tpu_torch.ops import crout

    dev = torch.device("cuda")

    class ReuseK9W(torch.autograd.Function):
        @staticmethod
        def forward(ctx, K, Y, panel):
            L, alpha, W = fops.factor_solve_fused(K, Y, panel, return_winv=True)
            ctx.save_for_backward(L, W, alpha)
            ctx.panel = panel
            return L, alpha

        @staticmethod
        def backward(ctx, Lbar, abar):
            L, W, alpha = ctx.saved_tensors
            return (*fops._fleet_pullback(L, W, alpha, Lbar, abar, ctx.panel), None)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    def grad(X, Y, P0, **kw):
        p = P0.clone().requires_grad_()
        v = fleet.mll_batched(tg.Gaussian(p[:, 0], p[:, 1]), X, Y, 0.1, batched_kernel=True, **kw)
        return torch.autograd.grad(v.sum(), p)[0]

    r1 = np.random.default_rng(22)
    X1 = r1.standard_normal((4, 256, 3))
    Y1 = np.sin(X1.sum(-1, keepdims=True)) + 0.1 * r1.standard_normal((4, 256, 2))
    P1 = np.array([[1.2, 0.9], [1.5, 1.0], [2.0, 1.1], [1.1, 1.2]])
    r0 = np.random.default_rng(0)
    X2 = r0.standard_normal((128, 512, 8))
    Y2 = r0.standard_normal((128, 512, 4))
    P2 = np.stack([np.linspace(1.5, 3.0, 128), np.linspace(0.8, 1.2, 128)], 1)
    for name, X, Y, P in (("B=4 n=256", X1, Y1, P1), ("B=128 n=512", X2, Y2, P2)):
        X32 = torch.tensor(X, dtype=torch.float32, device=dev)
        Y32 = torch.tensor(Y, dtype=torch.float32, device=dev)
        P0 = torch.tensor(P, dtype=torch.float64, device=dev)
        g64 = grad(X32.double(), Y32.double(), P0, use_crout=False)
        g32 = grad(X32, Y32, P0, use_crout=False)
        out = {"plain f32 (cuSOLVER)": rel(g32, g64)}
        fops._FLEET_FUSED_MAX_N = 0
        out["fleet-crout, its own W"] = rel(grad(X32, Y32, P0, use_crout=True), g64)
        fops._FLEET_FUSED_MAX_N = 1024
        out["fleet-fused, W = K8(D D^T)"] = rel(grad(X32, Y32, P0, use_crout=True), g64)
        os.environ["GPR_FLEET_DIAG"] = "xla"
        out["fleet-fused, W = trsm(D, I)"] = rel(grad(X32, Y32, P0, use_crout=True), g64)
        del os.environ["GPR_FLEET_DIAG"]
        orig = fops.factor_solve_fused_diff
        fops.factor_solve_fused_diff = lambda K, Y_, panel: ReuseK9W.apply(K, Y_, panel)
        try:
            out["fleet-fused, K9's own W"] = rel(grad(X32, Y32, P0, use_crout=True), g64)
        finally:
            fops.factor_solve_fused_diff = orig
        print(f"{name}: gradient rel err vs f64: "
              + "; ".join(f"{k} {v:.3g}" for k, v in out.items()))
        # W of the fused factor's diagonal blocks, four ways, against inv(D) in float64
        with torch.no_grad():
            K = fleet._fleet_gram(tg.Gaussian(P0[:, 0], P0[:, 1]), X32, torch.full(
                (X32.shape[0],), 0.01, device=dev), True)
            p = fops.FUSED_PANEL
            L, _, W9 = fops.factor_solve_fused(K, Y32, p, return_winv=True)
            nb = L.shape[-1] // p
            D = torch.stack([L[:, i * p:(i + 1) * p, i * p:(i + 1) * p] for i in range(nb)], 1)
            truth = torch.linalg.inv(D.double())
            w_k8 = crout.crout_chol_wi(torch.matmul(D, D.mT).reshape(-1, p, p))[1].reshape(D.shape)
            w_tr = fops._tri_inverse(D)
            print(f"  W rel err vs inv(D) in f64 (panel {p}, {D.shape[0] * nb} blocks): "
                  f"K8(D D^T) {rel(w_k8, truth):.3g}; trsm {rel(w_tr, truth):.3g}; "
                  f"K9 {rel(W9, truth):.3g}; cond(D) max {float(torch.linalg.cond(D.double()).max()):.4g}")
        fops._FLEET_FUSED_MAX_N = 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
