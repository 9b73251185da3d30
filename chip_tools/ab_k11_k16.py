#!/usr/bin/env python3
"""Time K11 (diag_tri_inv) and K16 (rank_update_tiles) for the
gpr_tpu_torch package under a given root, on one CUDA card, with the paths
that run them: the narrow solve and the in-place factorization.

    python3 chip_tools/ab_k11_k16.py <root> <label>

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card to compare them, e.g. with the parent unpacked into the
gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in tmp_chip/parent . . tmp_chip/parent; do
        python3 chip_tools/ab_k11_k16.py $t $t; done

Prints one line (ms, CUDA events): K11 at n=16384, bs=512 (32 tiles of the
bench factor, row-major as the port's factorizations write it, so that no
layout copy is timed; 10 launches, each queued behind a device sleep so that the
host's enqueue is not timed), the narrow solve cho_solve_narrow at q=8 with
K11 (6 runs), K16 summed over the 63 calls of the n=16384 in-place schedule
on the bench K (per-call events, each call queued behind a sleep; 2 walks),
the in-place factorization cholesky_inplace (5 runs) and the bench fit under
GPR_CHOL_SCHEDULE=inplace (4 runs).  The first run of each is a warm-up and
is dropped.
"""

import os
import sys

import numpy as np

from ab_harness import med, timed


def main() -> int:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import _cuda, inplace_chol, solve

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    n, d, q = 16384, 128, 8
    rng0 = np.random.default_rng(0)
    Xb = torch.tensor(rng0.standard_normal((n, d)), dtype=torch.float32, device=dev)
    Yb = torch.tensor(rng0.standard_normal((n, q)), dtype=torch.float32, device=dev)

    d2 = (Xb * Xb).sum(1)[:, None] + (Xb * Xb).sum(1)[None, :] - 2.0 * (Xb @ Xb.T)
    K = (-0.5 * d2.clamp(min=0.0) / 64.0).exp()
    del d2
    K.diagonal().add_(float(np.float32(0.1)) ** 2)
    L = torch.linalg.cholesky(K).contiguous()  # row-major, as the port's factorizations write L
    k11 = [timed(lambda: solve.diag_tri_inv(L, 512), True) for _ in range(11)][1:]
    narrow = [timed(lambda: solve.cho_solve_narrow(L, Yb, diag_inv="pallas")) for _ in range(7)][1:]
    del L
    torch.cuda.empty_cache()
    k16 = []
    for _ in range(3):
        S = K.clone()
        tot = 0.0
        for st in inplace_chol.schedule(n, 512, 256, dev):
            if st[0] == "panel":
                inplace_chol.panel_inplace(S, st[1])
            else:
                _, rows, cols, kcols, bm = st
                tot += timed(lambda: inplace_chol._rank_update_tiles(S, rows, cols, kcols, bm, bm), True)
        if not bool(torch.isfinite(S[-1, -1])):
            raise RuntimeError("the in-place walk failed")
        k16.append(tot)
        del S
    k16 = k16[1:]
    fact = [timed(lambda: inplace_chol.cholesky_inplace(K)) for _ in range(6)][1:]
    del K
    torch.cuda.empty_cache()
    os.environ["GPR_CHOL_SCHEDULE"] = "inplace"
    bench_k = tg.Gaussian(8.0, 1.0)
    fit = [timed(lambda: tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)) for _ in range(5)][1:]

    print(f"{label}: K11 {med(k11)}; narrow solve {med(narrow)}; K16 per factorization {med(k16)}; "
          f"cholesky_inplace {med(fact)}; inplace bench fit {med(fit)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
