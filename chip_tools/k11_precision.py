#!/usr/bin/env python3
"""K11 diag_tri_inv's error against a float64 inverse, on one CUDA card.

    python3 chip_tools/k11_precision.py [<root> [<label>]]

<root> holds a gpr_tpu_torch/ directory (default: this checkout); run it for
two trees to set one K11 beside the other, e.g. the parent unpacked with git
archive into the gitignored tmp_chip/ (see chip_tools/ab_k11_k16.py).

On the 32 diagonal tiles of 512 of the bench factor (Gaussian(8, 1), n=16384,
d=128, sigma 0.1, seed 0; the float32 factor of torch.linalg.cholesky) and
on a synthetic 512 tile of cond ~1e4 (A's eigenvalues 1 .. 1e-8), it prints
for K11, its plain version (row substitution in float32) and one batched
torch.linalg.solve_triangular the max and the rms error of W = inv(L_ii)
against the float64 inverse of the same float32 tile, each over the largest
|entry| of that inverse (max and rms over the tiles).
"""

import os
import sys

import numpy as np


def errors(W, ref):
    d = W.double() - ref
    m = ref.abs().amax(dim=(-2, -1), keepdim=True)
    mx = (d.abs() / m).amax(dim=(-2, -1))
    rms = ((d / m) ** 2).mean(dim=(-2, -1)).sqrt()
    return float(mx.max()), float(rms.pow(2).mean().sqrt())


def main() -> int:
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    label = sys.argv[2] if len(sys.argv) > 2 else root
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import solve

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    if not torch.cuda.is_available():
        print("k11_precision: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    n, d, bs = 16384, 128, 512
    X = torch.tensor(np.random.default_rng(0).standard_normal((n, d)), dtype=torch.float32, device=dev)
    d2 = (X * X).sum(1)[:, None] + (X * X).sum(1)[None, :] - 2.0 * (X @ X.T)
    K = (-0.5 * d2.clamp(min=0.0) / 64.0).exp()
    del d2
    K.diagonal().add_(float(np.float32(0.1)) ** 2)
    L = torch.linalg.cholesky(K)
    del K
    rng = np.random.default_rng(24)
    Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
    A = (Q * np.logspace(0, -8, bs)) @ Q.T
    Ls = torch.tensor(np.linalg.cholesky(A + 1e-12 * np.eye(bs)), dtype=torch.float32, device=dev)
    eye = torch.eye(bs, dtype=torch.float32, device=dev)
    for name, Lc in (("bench factor, 32 tiles", L), ("cond ~1e4 tile", Ls)):
        tiles = solve._diag_tiles(Lc, bs)
        ref = torch.linalg.inv(torch.tril(tiles).double())
        res = {"K11": errors(solve.diag_tri_inv(Lc, bs), ref),
               "plain": errors(solve.diag_tri_inv_reference(Lc, bs), ref),
               "solve_triangular": errors(torch.linalg.solve_triangular(torch.tril(tiles), eye, upper=False), ref)}
        print(f"{label}: {name} (cond of L_ii up to "
              f"{float(torch.linalg.cond(torch.tril(tiles).double()).max()):.3g}), (max, rms) error over the "
              "largest |entry|: " + "; ".join(f"{k} ({a:.3g}, {b:.3g})" for k, (a, b) in res.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
