#!/usr/bin/env python3
"""Time K2 (panel_update) per fit and the fused-gram fit at n=16384, d=128,
q=8 for the gpr_tpu_torch package under a given root, on one CUDA card.

    python3 chip_tools/ab_panel_update.py <root> <label>

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card to compare them.  Prints one line: K2's total per
fit (sum of per-launch CUDA events) for 3 factorizations and 4 fit times
(the first includes the build and warm-up), in ms.
"""

import sys

import numpy as np


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import _cuda, fullchol

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    n, d, q, panel = 16384, 128, 8, 128
    rng0 = np.random.default_rng(0)
    Xb = torch.tensor(rng0.standard_normal((n, d)), dtype=torch.float32, device=dev)
    Yb = torch.tensor(rng0.standard_normal((n, q)), dtype=torch.float32, device=dev)
    args = ("gaussian", 8.0, 1.0, 1.0, float(np.float32(0.1) ** 2))

    def timed(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    nc = n // panel
    k2 = []
    for _ in range(3):
        L = torch.empty((n, n), device=dev)
        W = torch.empty((nc, panel, panel), device=dev)
        tot = 0.0
        for j in range(nc):
            tot += timed(lambda: fullchol.panel_update(L, j, Xb, *args))
            fullchol.diag_factor_inv(L, W, j)
            fullchol.panel_solve(L, W, j)
        k2.append(tot)
    fit = [timed(lambda: tg.fit(tg.Gaussian(8.0, 1.0), Xb, Yb, sigma=0.1, use_pallas_gram=True))
           for _ in range(4)]
    print(f"{label}: K2 per fit {[round(x, 2) for x in k2]} ms; fit {[round(x, 2) for x in fit]} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
