#!/usr/bin/env python3
"""K4's product P W_j^T in three precisions against float64, on one CUDA card.

    python3 chip_tools/k4_precision.py

At the panels j = 64 and 120 of the bench fit's factorization (Gaussian(8,
1), n=16384, d=128, sigma 0.1) and j = 4 of a window-sized one (Gaussian(2,
1), n=1024, d=5), P and W_j come from the kernels' own factorization up to
panel j.  It prints, for K4 (FP32 FMA), torch.matmul (cuBLAS FP32) and the
3xTF32 tensor-core tile at the same shape, the max and the rms error of P
W_j^T against float64, each over the largest |entry|.  The 3xTF32 tile is
reached through K2's last slice (csrc/fullchol.cu::panel_last_kernel),
which subtracts L[rows, panel i - 1] L[panel i, panel i - 1]^T: on a zero
matrix with W_j in the first 128 rows of that column block and P below it,
K2 of panel i writes -P W_j^T past its first tile.

Then it prints the ratio that tests/test_torch_cuda.py::
test_sliding_window_on_the_card gates at 3 (alpha's error after fit, extend
and shrink against a float64 fit, over the float32 CPU fit's) for the
test's seed 34 and seeds 35-36, with K4 as it is and with K4 replaced by its
plain version (cuBLAS).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gpr_tpu_torch as tg  # noqa: E402
from gpr_tpu_torch.ops import fullchol  # noqa: E402

DEV = torch.device("cuda")
P_ = fullchol.PANEL


def t32(a):
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=DEV)


def errors(x, ref):
    d = x.double() - ref
    m = ref.abs().max()
    return float(d.abs().max() / m), float(d.pow(2).mean().sqrt() / m)


def k4_three_ways(n, d, sigma, j):
    X = t32(np.random.default_rng(0).standard_normal((n, d)))
    args = ("gaussian", sigma, 1.0, 1.0, float(np.float32(0.1) ** 2))
    L = torch.empty((n, n), device=DEV)
    W = torch.empty((n // P_, P_, P_), device=DEV)
    for i in range(j):
        fullchol.panel_update(L, i, X, *args)
        fullchol.diag_factor_inv(L, W, i)
        fullchol.panel_solve(L, W, i)
    fullchol.panel_update(L, j, X, *args)
    fullchol.diag_factor_inv(L, W, j)
    P = L[(j + 1) * P_:, j * P_:(j + 1) * P_].clone()
    ref = P.double() @ W[j].double().T
    Lk = L.clone()
    fullchol.panel_solve(Lk, W, j)
    k4 = Lk[(j + 1) * P_:, j * P_:(j + 1) * P_]
    cublas = P @ W[j].T
    # the 3xTF32 tile: K2 of panel i = j + 1 on a zero matrix whose column
    # block j holds W_j over P.  S and the products over the columns before
    # are 0, so the strip writes minus the last slice, L[rows, panel j]
    # L[panel i, panel j]^T, whose rows past the first tile are -P W_j^T.
    i = j + 1
    T = torch.zeros((n, n), device=DEV)
    T[i * P_:(i + 1) * P_, j * P_:i * P_] = W[j]
    T[(i + 1) * P_:, j * P_:i * P_] = P[:n - (i + 1) * P_]
    fullchol.panel_update(T, i, torch.zeros((n, n), device=DEV))
    tc = -T[(i + 1) * P_:, i * P_:(i + 1) * P_]
    rows = tc.shape[0]
    return {"K4 FP32": errors(k4[:rows], ref[:rows]), "cuBLAS": errors(cublas[:rows], ref[:rows]),
            "3xTF32 tile": errors(tc, ref[:rows]), "max |W_j|": float(W[j].abs().max())}


def window_ratio(seed):
    rng = np.random.default_rng(seed)
    n, k = 1024, 512
    X = rng.standard_normal((n + k, 5))
    Y = np.sin(X[:, :3]) + 0.1 * rng.standard_normal((n + k, 3))
    kern = tg.Gaussian(2.0, 1.0)
    gp = tg.fit(kern, t32(X[:n]), t32(Y[:n]), 0.1, use_pallas_gram=False)
    gp = tg.extend(gp, t32(X[n:]), t32(Y[n:]))
    gp = tg.shrink(gp, k)
    ref = tg.fit(kern, X[k:], Y[k:], float(np.float32(0.1)), device="cpu")
    cpu32 = tg.fit(kern, X[k:].astype(np.float32), Y[k:].astype(np.float32), 0.1, device="cpu")

    def rel(a, b):
        return float((a.double().cpu() - b).abs().max() / b.abs().max())

    return rel(gp.alpha, ref.alpha) / rel(cpu32.alpha.double(), ref.alpha)


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_precision: no CUDA device", file=sys.stderr)
        return 1
    for n, d, sigma, j in ((16384, 128, 8.0, 64), (16384, 128, 8.0, 120), (1024, 5, 2.0, 4)):
        res = k4_three_ways(n, d, sigma, j)
        print(f"P W_j^T at n={n} j={j} (max |W_j| {res.pop('max |W_j|'):.3g}), (max, rms) error over "
              "the largest |entry|: " + "; ".join(f"{k} ({a:.3g}, {b:.3g})" for k, (a, b) in res.items()),
              flush=True)
    os.environ["GPR_SOLVE_SCHEDULE"] = "narrow"  # as the test
    print("window alpha ratio (gate 3), seeds 34-36: K4 "
          f"{[round(window_ratio(s), 3) for s in (34, 35, 36)]}", flush=True)
    kernel = fullchol.panel_solve

    def plain(L, W, j):
        if (j + 1) * P_ < L.shape[0]:
            fullchol.panel_solve_reference(L, W, j)

    fullchol.panel_solve = plain
    try:
        print("window alpha ratio (gate 3), seeds 34-36: K4 -> cuBLAS "
              f"{[round(window_ratio(s), 3) for s in (34, 35, 36)]}", flush=True)
    finally:
        fullchol.panel_solve = kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
