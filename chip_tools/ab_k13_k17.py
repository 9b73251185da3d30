#!/usr/bin/env python3
"""Time K13 (leaf_chol_wi) and K17 (panel_inplace) for the gpr_tpu_torch
package under a given root, on one CUDA card, beside their library calls,
with the factorizations that run them and the kernels that share their code
(K11, K12, K15, K19, K20).

    python3 chip_tools/ab_k13_k17.py <root> <label> [k13]

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card to compare them, e.g. with the parent unpacked into the
gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in tmp_chip/parent . . tmp_chip/parent; do
        python3 chip_tools/ab_k13_k17.py $t $t; done

Prints, in ms (CUDA events, median and runs after a warm-up):
- K13 per leaf at s = 256, 512 and 1024 (G G^T / s + I, as chip_smoke.py
  phase 18's) against torch.linalg.cholesky_ex + solve_triangular(L, I) on
  the same leaf, 10 rounds in turns: each call queued behind a device sleep,
  so that the host's enqueue is not timed ("queued"), then each call with
  the host's time to enqueue it ("enqueue"); K12 at 1024 queued;
- K17 summed over the 64 calls of the n = 16384 in-place schedule on the
  bench K (Gaussian(8, 1) of the bench's X, sigma 0.1), each call queued,
  against cholesky_ex + solve_triangular of the same panels (the walk's K16
  calls run untimed between them), 3 walks in turns; then one walk under
  torch.profiler: the device time of each kernel that K17 launches;
- K15 summed over the 32 panels of cholesky_left_panels at n = 8192, each
  call queued, 3 walks; K11 at n = 16384, bs = 512 (10 launches, queued);
  K19 and K20 (sw 8) at n = 512 (10 rounds, queued);
- the n = 16384 factorization of the bench K on blocked-syrk-leaf (K13 on
  16 leaves), blocked-syrk, inplace (64 K17) and torch.linalg.cholesky, 5
  rounds in turns, each with the host's enqueue.
With the third argument k13, only the K13 and K12 lines.
"""

import os
import sys

import numpy as np

from ab_harness import device_split, med, rounds, timed


def main() -> int:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import _cuda, blocked, chol, inplace_chol, leaf, panel, solve

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)

    def spd(n):
        G = torch.randn((n, n), generator=g, device=dev)
        A = G @ G.T / n
        A.diagonal().add_(1.0)
        return A

    for s in (256, 512, 1024):
        A = spd(s)
        eye = torch.eye(s, device=dev)
        fns = {"K13": lambda: leaf.leaf_cholesky_wi(A),
               "cholesky_ex + solve_triangular": lambda: torch.linalg.solve_triangular(
                   torch.linalg.cholesky_ex(A)[0], eye, upper=False)}
        print(f"{label} K13 s={s}: queued: {rounds(fns, 10, True)} | enqueue: {rounds(fns, 10, False)}", flush=True)
        if s == 1024:
            print(f"{label} K12 s=1024 queued: {rounds({'K12': lambda: leaf.leaf_cholesky(A)}, 10, True)}",
                  flush=True)
            print(f"{label} K13 s=1024 split (torch.profiler, device ms): "
                  + device_split(lambda: leaf.leaf_cholesky_wi(A)), flush=True)

    if sys.argv[3:] == ["k13"]:
        return 0
    # the bench K at n = 16384
    n, d = 16384, 128
    rng0 = np.random.default_rng(0)
    X = torch.tensor(rng0.standard_normal((n, d)), dtype=torch.float32, device=dev)
    d2 = (X * X).sum(1)[:, None] + (X * X).sum(1)[None, :] - 2.0 * (X @ X.T)
    K = (-0.5 * d2.clamp(min=0.0) / 64.0).exp()
    del d2
    K.diagonal().add_(float(np.float32(0.1)) ** 2)

    def lib_panel(S, c):  # reads S's panel, writes nothing
        c0, e = c * 256, (c + 1) * 256
        low = torch.tril(S[c0:e, c0:e])
        Lk = torch.linalg.cholesky_ex(low + torch.tril(low, -1).mT)[0]
        if e < n:
            torch.linalg.solve_triangular(Lk.mT, S[e:, c0:e], upper=True, left=False)
        return Lk

    walks = {"K17": [], "cholesky_ex + solve_triangular": []}
    for i in range(3):
        for mode in (list(walks) if i % 2 == 0 else list(walks)[::-1]):
            S = K.clone()
            tot = 0.0
            for st in inplace_chol.schedule(n, 512, 256, dev):
                if st[0] == "panel":
                    if mode == "K17":
                        tot += timed(lambda: inplace_chol.panel_inplace(S, st[1]), True)
                    else:  # the library's panel is timed, the walk goes on with the kernel's
                        tot += timed(lambda: lib_panel(S, st[1]), True)
                        inplace_chol.panel_inplace(S, st[1])
                else:
                    _, rows, cols, kcols, bm = st
                    inplace_chol._rank_update_tiles(S, rows, cols, kcols, bm, bm)
            if not bool(torch.isfinite(S[-1, -1])):
                raise RuntimeError(f"the in-place walk ({mode}) failed")
            walks[mode].append(tot)
            del S
            torch.cuda.empty_cache()
    print(f"{label} K17 per n={n} inplace factorization (64 calls, queued): "
          + "; ".join(f"{k} {med(v)}" for k, v in walks.items()), flush=True)
    print(f"{label} K17 split (torch.profiler, device ms over one cholesky_inplace): "
          + device_split(lambda: inplace_chol.cholesky_inplace(K)), flush=True)

    facts = {"blocked-syrk-leaf": lambda: blocked.cholesky_blocked(K, leaf_inverse=True),
             "blocked-syrk": lambda: blocked.cholesky_blocked(K, leaf_inverse=False),
             "inplace": lambda: inplace_chol.cholesky_inplace(K),
             "torch.linalg.cholesky": lambda: torch.linalg.cholesky(K)}
    print(f"{label} factorization n={n} (bench K, with the host's enqueue): {rounds(facts, 5, False)}", flush=True)

    L = torch.linalg.cholesky(K).contiguous()  # row-major, as the port's factorizations write L
    del K
    torch.cuda.empty_cache()
    print(f"{label} K11 n={n} bs=512 queued: {rounds({'K11': lambda: solve.diag_tri_inv(L, 512)}, 10, True)}",
          flush=True)
    del L
    torch.cuda.empty_cache()

    n8 = 8192
    A8 = spd(n8)
    L8 = torch.zeros_like(A8)
    panels = []
    for k in range(n8 // 256):
        j0 = k * 256
        P = A8[j0:, j0:j0 + 256]
        if k > 0:
            P = P - L8[j0:, :j0] @ L8[j0:j0 + 256, :j0].mT
        panels.append(P)
        L8[j0:, j0:j0 + 256] = panel.panel_factor(P)
    if not bool(torch.isfinite(L8[-1, -1])):
        raise RuntimeError("the left-looking panels failed")
    w15 = [sum(timed(lambda: panel.panel_factor(P), True) for P in panels) for _ in range(4)][1:]
    print(f"{label} K15 per n={n8} cholesky_left_panels (32 panels, queued): {med(w15)}", flush=True)
    del A8, L8, panels
    A5 = spd(512)
    print(f"{label} K19/K20 n=512 queued: " + rounds({"K19": lambda: chol.cholesky_tile(A5),
                                                     "K20 sw=8": lambda: chol.cholesky_tile_v2(A5, sw=8)},
                                                    10, True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
