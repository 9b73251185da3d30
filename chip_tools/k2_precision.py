#!/usr/bin/env python3
"""K2 panel_update's error on the card against float64, beside the plain
FP32 version's, at the bench fit's shapes (n=16384, d=128, Gaussian(8, 1),
sigma 0.1).

    python3 chip_tools/k2_precision.py

Factors panels 0 .. j-1 with the kernels, then for each panel j in a few
depths computes P = S - L21 L_j^T three ways from the same L: K2 (3xTF32 on
the tensor cores), its plain torch version (cuBLAS FP32, TF32 off) and
float64.  Prints the max and rms error of each against float64, relative to
the largest |P|.
"""

import sys

import numpy as np


def main() -> int:
    import torch

    sys.path.insert(0, ".")
    from gpr_tpu_torch.ops import fullchol

    dev = torch.device("cuda")
    n, d, P = 16384, 128, fullchol.PANEL
    X = torch.tensor(np.random.default_rng(0).standard_normal((n, d)), dtype=torch.float32,
                     device=dev)
    args = ("gaussian", 8.0, 1.0, 1.0, float(np.float32(0.1) ** 2))
    L = torch.empty((n, n), dtype=torch.float32, device=dev)
    W = torch.empty((n // P, P, P), dtype=torch.float32, device=dev)
    for j in range(n // P - 1):
        if j in (16, 64, 124):
            jp, cols = j * P, slice(j * P, (j + 1) * P)
            Lk, Lp = L.clone(), L.clone()
            fullchol.panel_update(Lk, j, X, *args)
            fullchol.panel_update_reference(Lp, j, X, *args)
            Ls = L.clone()
            Ls[:, :jp] = 0.0  # the plain version's strip S alone
            fullchol.panel_update_reference(Ls, j, X, *args)
            P64 = Ls[jp:, cols].double() - L[jp:, :jp].double() @ L[jp:jp + P, :jp].double().T
            scale = float(P64.abs().max())
            for name, M in (("K2 3xTF32", Lk), ("plain FP32", Lp)):
                e = M[jp:, cols].double() - P64
                print(f"j={j} (k={jp}): {name}: max err {float(e.abs().max()) / scale:.3e}, "
                      f"rms {float(e.pow(2).mean().sqrt()) / scale:.3e} of max |P| {scale:.3e}",
                      flush=True)
        fullchol.panel_update(L, j, X, *args)
        fullchol.diag_factor_inv(L, W, j)
        fullchol.panel_solve(L, W, j)
    return 0


if __name__ == "__main__":
    sys.exit(main())
