#!/usr/bin/env python3
"""Time K8 (crout_chol_wi) and K9 (fleet_fused) for the gpr_tpu_torch package
under a given root, on one CUDA card, with the paths that run them and the
kernels that share their sources, and save every kernel's output so that
two trees can be compared bit for bit.

    python3 chip_tools/ab_k8_k9.py <root> <label> [<outdir>]
    python3 chip_tools/ab_k8_k9.py --compare <a.pt> <b.pt>

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card, then compare their saved outputs, e.g. with the parent
unpacked into the gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in parent:tmp_chip/parent change:. change2:. parent2:tmp_chip/parent; do
        python3 chip_tools/ab_k8_k9.py ${t#*:} ${t%%:*} tmp_chip/ab; done
    python3 chip_tools/ab_k8_k9.py --compare tmp_chip/ab/parent.pt tmp_chip/ab/change.pt

Prints (ms, CUDA events, median and runs; the first run of each is a
warm-up and is dropped), on benchmarks/bench_batched.py's data (Gaussian(2,
1), sigma 0.1, d = 8, q = 4):
  * K8 per fleet factorization under GPR_FLEET_DIAG=crout at B=128, n=512
    (4 launches of 128 tiles of 128), each diagonal step queued behind a
    device sleep, in turns with crout_xlaw's K7 + triangular solve against I
    and with torch.linalg.cholesky_ex + the same solve; K8 on the fused
    backward's D D^T tiles (1024 tiles of 64, one launch), queued;
  * K9 alone at B=128, n=512 and B=256, n=1024, panels 64 and 128, queued
    (and at q = 1 and 12 at B=128, panel 64: one and two substitution
    passes); the fused and the panel-stepped fleet fit at both sizes in turns
    (with the host's enqueue); the fused mll_batched value + gradient at
    B=128, n=512 (per-member (lengthscale, scale));
  * the kernels that share K8's and K9's headers (crout.cuh, gram_tile.cuh)
    or that the change must leave alone, queued: K7 per fleet
    factorization at B=128, n=512; K11 at n=16384, bs=512; K12, K13 and K14
    on a 1024 leaf; K1 at n=384 and (lower triangle) 4096, d=128; K6 on the
    fleet's data at B=128, n=512; the bench factorization at n=16384, d=128
    (K2-K4, gram_cholesky_fused; with the host's enqueue).
--compare prints, for every saved output, whether the two trees' are equal
bit for bit, else the largest difference relative to the largest entry.
"""

import os
import sys

import numpy as np

from ab_harness import compare, med, runs, timed


def main() -> int:
    if sys.argv[1] == "--compare":
        return compare(sys.argv[2], sys.argv[3])
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    outdir = sys.argv[3] if len(sys.argv) > 3 else None
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import _cuda, crout, fullchol, leaf, solve
    from gpr_tpu_torch.ops import batched as fbatched
    from gpr_tpu_torch.ops import gram as gop

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    saved = {}

    def turns(fns, k, sleep=False):
        """Each fn in turns, the order reversed every round; the first round
        is a warm-up."""
        out = {name: [] for name in fns}
        names = list(fns)
        for i in range(k + 1):
            for name in (names if i % 2 == 0 else names[::-1]):
                t = timed(fns[name], sleep)
                if i:
                    out[name].append(t)
        return out

    out = []
    sig = float(np.float32(0.1))
    k_f = tg.Gaussian(2.0, 1.0)

    def data(B, n, q=4):
        r = np.random.default_rng(0)  # benchmarks/bench_batched.py:31-34
        X = torch.tensor(r.standard_normal((B, n, 8)), dtype=torch.float32, device=dev)
        Y = torch.tensor(r.standard_normal((B, n, q)), dtype=torch.float32, device=dev)
        P = torch.tensor(np.tile([2.0, 1.0, 1.0, sig * sig], (B, 1)), dtype=torch.float32, device=dev)
        return X, Y, gop.gram_batched(X, P)

    X, Y, K = data(128, 512)
    Pf = torch.tensor(np.tile([2.0, 1.0, 1.0, sig * sig], (128, 1)), dtype=torch.float32, device=dev)
    saved["K6 B=128 n=512"] = K.cpu()
    out.append(f"K6 B=128 n=512 d=8 (queued): {med(runs(lambda: gop.gram_batched(X, Pf), 10, True))}")

    # K8 per fleet factorization under GPR_FLEET_DIAG=crout, each step queued
    def k7_trsm(D, out_):
        L = crout.crout_chol(D, out=out_)
        return L, fbatched._tri_inverse(L)

    def library(D, out_):
        L = out_.copy_(torch.linalg.cholesky_ex(D)[0])
        return L, fbatched._tri_inverse(L)

    steps = {"K8": lambda D, out_: crout.crout_chol_wi(D, L_out=out_), "K7 + trsm": k7_trsm,
             "cholesky_ex + trsm": library}

    def per_fit(step):
        tot = [0.0]

        def timed_diag(D, out=None):
            box = []
            tot[0] += timed(lambda: box.append(step(D, out)), True)
            return box[0]

        L = fbatched.cholesky_batched(K, diag=timed_diag)
        return tot[0], L

    per = {name: [] for name in steps}
    for i in range(7):
        for name in (list(steps) if i % 2 == 0 else list(steps)[::-1]):
            t, L = per_fit(steps[name])
            if i:
                per[name].append(t)
            if name == "K8":
                saved["fleet factor under crout B=128 n=512"] = L.cpu()
    out.append("per fleet factorization under GPR_FLEET_DIAG=crout, B=128 n=512 (4 steps, queued): "
               + "; ".join(f"{name} {med(v)}" for name, v in per.items()))
    D = K[:, :128, :128].contiguous()
    L8, W8 = crout.crout_chol_wi(D)
    saved["K8 B=128 b=128 L"], saved["K8 B=128 b=128 W"] = L8.cpu(), W8.cpu()
    Lf = fbatched.cholesky_batched(K)
    Df = torch.stack([Lf[:, i * 64:(i + 1) * 64, i * 64:(i + 1) * 64] for i in range(8)], 1).reshape(-1, 64, 64)
    DDt = torch.matmul(Df, Df.mT)
    L8, W8 = crout.crout_chol_wi(DDt)
    saved["K8 D D^T W"] = W8.cpu()
    out.append("K8 on D D^T (1024 tiles of 64, 1 launch, queued): "
               f"{med(runs(lambda: crout.crout_chol_wi(DDt), 10, True))}")
    out.append(f"K8 on B=128 tiles of 128 (1 launch, queued): {med(runs(lambda: crout.crout_chol_wi(D), 10, True))}")

    # K7 per fleet factorization (crout_xlaw), its factor saved
    def k7_fit():
        tot = [0.0]

        def timed_k7(D_, out=None):
            box = []
            tot[0] += timed(lambda: box.append(crout.crout_chol(D_, out=out)), True)
            return box[0]

        orig = fbatched.crout_chol
        fbatched.crout_chol = timed_k7
        try:
            L = fbatched.cholesky_batched(K)
        finally:
            fbatched.crout_chol = orig
        return tot[0], L

    k7 = [k7_fit() for _ in range(7)]
    saved["K7 fleet factor B=128 n=512"] = k7[-1][1].cpu()
    out.append(f"K7 per fleet factorization B=128 n=512 (4 launches, queued): {med([t for t, _ in k7[1:]])}")

    # K9 alone, both sizes and panels; the fits; the value + gradient
    for B, n in ((128, 512), (256, 1024)):
        if n != 512:
            del X, Y, K
            torch.cuda.empty_cache()
            X, Y, K = data(B, n)
        for p in (64, 128):
            L9, X9 = fbatched.factor_solve_fused(K, Y, p)  # members 0-7 saved
            saved[f"K9 B={B} n={n} p={p} L"], saved[f"K9 B={B} n={n} p={p} alpha"] = L9[:8].cpu(), X9.cpu()
            out.append(f"K9 B={B} n={n} panel {p} (queued): "
                       f"{med(runs(lambda: fbatched.factor_solve_fused(K, Y, p), 8, True))}")
        if n == 512:
            for q in (1, 12):
                Yq = torch.tensor(np.random.default_rng(1).standard_normal((B, n, q)), dtype=torch.float32, device=dev)
                out.append(f"K9 B={B} n={n} panel 64 q={q} (queued): "
                           f"{med(runs(lambda: fbatched.factor_solve_fused(K, Yq, 64), 8, True))}")

        def fit_at(max_n):
            saved_max = fbatched._FLEET_FUSED_MAX_N
            fbatched._FLEET_FUSED_MAX_N = max_n
            try:
                tg.fit_batched(k_f, X, Y, 0.1)
            finally:
                fbatched._FLEET_FUSED_MAX_N = saved_max

        fits = turns({"fused": lambda: fit_at(1024), "panel-stepped": lambda: fit_at(0)}, 8)
        out.append(f"fleet fit B={B} n={n} (with the host's enqueue): "
                   + "; ".join(f"{name} {med(v)}" for name, v in fits.items()))
        if n == 512:
            P0 = torch.tensor(np.stack([np.linspace(1.5, 3.0, B), np.linspace(0.8, 1.2, B)], 1),
                              dtype=torch.float32, device=dev)  # chip_smoke.py phase 9's

            def vg():
                saved_max = fbatched._FLEET_FUSED_MAX_N
                fbatched._FLEET_FUSED_MAX_N = 1024
                try:
                    p_ = P0.clone().requires_grad_(True)
                    v = tg.mll_batched(tg.Gaussian(p_[:, 0], p_[:, 1]), X, Y, 0.1, batched_kernel=True)
                    torch.autograd.grad(v.sum(), p_)
                finally:
                    fbatched._FLEET_FUSED_MAX_N = saved_max

            out.append(f"fused mll_batched value + gradient B={B} n={n}: {med(runs(vg, 6))}")
    del X, Y, K
    torch.cuda.empty_cache()

    # K11, K12, K13, K14
    n = 16384
    g = torch.Generator(device=dev).manual_seed(14)
    G = torch.randn((n, 64), generator=g, device=dev)
    A = G @ G.T / 64
    A.diagonal().add_(4.0)
    L = torch.linalg.cholesky(A).contiguous()
    del A, G
    saved["K11 n=16384 bs=512"] = solve.diag_tri_inv(L, 512).cpu()
    out.append(f"K11 n=16384 bs=512 (queued): {med(runs(lambda: solve.diag_tri_inv(L, 512), 10, True))}")
    del L
    s = 1024
    G = torch.randn((s, s), generator=g, device=dev)
    A = G @ G.T / s + torch.eye(s, device=dev)
    saved["K12 s=1024"] = leaf.leaf_cholesky(A).cpu()
    L13, W13 = leaf.leaf_cholesky_wi(A)
    saved["K13 s=1024 L"], saved["K13 s=1024 W"] = L13.cpu(), W13.cpu()
    saved["K14 s=1024"] = leaf.tri_inv_leaf(L13).cpu()
    out.append(f"K12 s=1024 (queued): {med(runs(lambda: leaf.leaf_cholesky(A), 10, True))}")
    out.append(f"K13 s=1024 (queued): {med(runs(lambda: leaf.leaf_cholesky_wi(A), 10, True))}")
    out.append(f"K14 s=1024 (queued): {med(runs(lambda: leaf.tri_inv_leaf(L13), 10, True))}")
    del A, G, L13, W13
    torch.cuda.empty_cache()
    # gram_tile.cuh: K1 and the bench factorization's K2-K4
    r = np.random.default_rng(0)
    Xb = torch.tensor(r.standard_normal((16384, 128)), dtype=torch.float32, device=dev)
    for nk, tril in ((384, False), (4096, True)):
        Xk = Xb[:nk].contiguous()
        saved[f"K1 n={nk} tril={tril}"] = gop.gram(Xk, Xk, 8.0, 1.0, tril=tril).cpu()
        out.append(f"K1 n={nk} d=128 tril={tril} (queued): "
                   f"{med(runs(lambda: gop.gram(Xk, Xk, 8.0, 1.0, tril=tril), 10, True))}")
    Lb, Wb = fullchol.gram_cholesky_fused(Xb, 8.0, 1.0, 1.0, 0.01, return_winv=True)
    saved["K2-K4 n=16384 L rows 15872-16383"], saved["K2-K4 n=16384 W"] = Lb[-512:].cpu(), Wb.cpu()
    del Lb, Wb
    out.append("bench factorization n=16384 d=128, K2-K4 (with the host's enqueue): "
               f"{med(runs(lambda: fullchol.gram_cholesky_fused(Xb, 8.0, 1.0, 1.0, 0.01), 6))}")
    for line in out:
        print(f"{label}: {line}", flush=True)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        torch.save(saved, os.path.join(outdir, f"{label}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
