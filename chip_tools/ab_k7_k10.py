#!/usr/bin/env python3
"""Time K7 (crout_chol) and K10 (narrow_subst) for the gpr_tpu_torch package
under a given root, on one CUDA card, with the paths that run them and the
kernels that share their sources, and save every kernel's output so that
two trees can be compared bit for bit.

    python3 chip_tools/ab_k7_k10.py <root> <label> [<outdir>]
    python3 chip_tools/ab_k7_k10.py --compare <a.pt> <b.pt>

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card, then compare their saved outputs, e.g. with the parent
unpacked into the gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in parent:tmp_chip/parent change:. change2:. parent2:tmp_chip/parent; do
        python3 chip_tools/ab_k7_k10.py ${t#*:} ${t%%:*} tmp_chip/ab; done
    python3 chip_tools/ab_k7_k10.py --compare tmp_chip/ab/parent.pt tmp_chip/ab/change.pt

(the saved outputs take ~1.2 GB).

Prints (ms, CUDA events, median and runs; the first run of each is a
warm-up and is dropped):
  * K7 per fleet factorization at B=128, n=512 (4 launches of 128 tiles of
    128x128) and B=256, n=1024 (8 launches of 256 tiles), each launch queued
    behind a device sleep, beside torch.linalg.cholesky_ex on the same tiles
    (benchmarks/bench_batched.py's data, Gaussian(2, 1), sigma 0.1); the
    fleet fit at both sizes with the host's enqueue;
  * K10's two sweeps at n=16384, bs=512, q=8 and q=128 (the factor of X X^T /
    64 + 4 I, row-major), queued and with the host's enqueue; the narrow
    solve cho_solve_narrow at q=8 (K11 + K10); the bench fit (n=16384,
    d=128, q=8) and one MLL value + gradient under GPR_SOLVE_SCHEDULE=narrow
    and GPR_SOLVE_DIAGINV=pallas;
  * the kernels that share K7's and K10's sources, queued: K8 on the fleet's
    first diagonal blocks (B=128, 128x128), K9 per fused fleet fit (B=128,
    n=512, panel 64), K11 at n=16384, bs=512.
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
    from gpr_tpu_torch.gp import batched as fleet
    from gpr_tpu_torch.gp import likelihood as lk
    from gpr_tpu_torch.ops import _cuda, crout, solve
    from gpr_tpu_torch.ops import batched as fbatched
    from gpr_tpu_torch.ops import gram as gop

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    saved = {}

    out = []
    sig = float(np.float32(0.1))
    # K7 per fleet factorization, each launch queued; then the fleet fit
    for B, n in ((128, 512), (256, 1024)):
        r = np.random.default_rng(0)  # benchmarks/bench_batched.py:31-34
        X = torch.tensor(r.standard_normal((B, n, 8)), dtype=torch.float32, device=dev)
        Y = torch.tensor(r.standard_normal((B, n, 4)), dtype=torch.float32, device=dev)
        P = torch.tensor(np.tile([2.0, 1.0, 1.0, sig * sig], (B, 1)), dtype=torch.float32, device=dev)
        K = gop.gram_batched(X, P)
        orig = fbatched.crout_chol

        def per_fit(diag):
            tot = [0.0]

            def timed_diag(D, out):
                box = []
                tot[0] += timed(lambda: box.append(diag(D)), True)
                return box[0] if box[0] is out else out.copy_(box[0])

            fbatched.crout_chol = timed_diag
            try:
                L = fbatched.cholesky_batched(K)
            finally:
                fbatched.crout_chol = orig
            return tot[0], L

        kern, lib = [], []
        for i in range(6):
            for name in (("kernel", "library") if i % 2 == 0 else ("library", "kernel")):
                if name == "kernel":
                    t, L = per_fit(lambda D: crout.crout_chol(D, out=D))
                    kern.append(t)
                else:
                    lib.append(per_fit(lambda D: torch.linalg.cholesky_ex(D)[0])[0])
        saved[f"K7 fleet factor B={B} n={n}"] = L.cpu()
        fit = runs(lambda: fleet.fit_batched(tg.Gaussian(2.0, 1.0), X, Y, 0.1), 10)
        out.append(f"K7 per fleet factorization B={B} n={n}: kernel {med(kern[1:])}; cholesky_ex {med(lib[1:])}; "
                   f"fleet fit {med(fit)}")
        if B == 128:
            D = K[:, :128, :128].contiguous()
            L8, W8 = crout.crout_chol_wi(D)
            saved["K8 B=128 b=128 L"], saved["K8 B=128 b=128 W"] = L8.cpu(), W8.cpu()
            k8 = runs(lambda: crout.crout_chol_wi(D), 10, True)
            Lf, Xf = fbatched.factor_solve_fused(K, Y, 64)
            saved["K9 B=128 n=512 L"], saved["K9 B=128 n=512 alpha"] = Lf.cpu(), Xf.cpu()
            k9 = runs(lambda: fbatched.factor_solve_fused(K, Y, 64), 10, True)
            out.append(f"K8 B=128 b=128: {med(k8)}; K9 B=128 n=512 panel 64: {med(k9)}")
        del X, Y, P, K
        torch.cuda.empty_cache()

    # K10's two sweeps, the narrow solve, K11
    n = 16384
    g = torch.Generator(device=dev).manual_seed(14)
    G = torch.randn((n, 64), generator=g, device=dev)
    A = G @ G.T / 64
    A.diagonal().add_(4.0)
    L = torch.linalg.cholesky(A).contiguous()  # row-major, as the port's factorizations write L
    del A, G
    W = solve.diag_tri_inv(L, 512)
    saved["K11 n=16384 bs=512"] = W.cpu()
    k11 = runs(lambda: solve.diag_tri_inv(L, 512), 10, True)
    for q in (8, 128):
        Bq = torch.randn((n, q), generator=g, device=dev)
        Yq = solve.subst_pass(L, W, Bq, True)
        saved[f"K10 forward q={q}"], saved[f"K10 backward q={q}"] = Yq.cpu(), solve.subst_pass(L, W, Yq, False).cpu()
        sweeps = lambda: solve.subst_pass(L, W, solve.subst_pass(L, W, Bq, True), False)  # noqa: E731
        qd, enq = runs(sweeps, 10, True), runs(sweeps, 10)
        out.append(f"K10 two sweeps n={n} q={q}: queued {med(qd)}; with the host's enqueue {med(enq)}")
        if q == 8:
            narrow = runs(lambda: solve.cho_solve_narrow(L, Bq, diag_inv="pallas"), 10)
    out.append(f"narrow solve n={n} q=8 (K11 + K10): {med(narrow)}; K11 queued {med(k11)}")
    del L, W
    torch.cuda.empty_cache()
    os.environ.update({"GPR_SOLVE_SCHEDULE": "narrow", "GPR_SOLVE_DIAGINV": "pallas"})
    r = np.random.default_rng(0)
    Xb = torch.tensor(r.standard_normal((n, 128)), dtype=torch.float32, device=dev)
    Yb = torch.tensor(r.standard_normal((n, 8)), dtype=torch.float32, device=dev)
    bench_k = tg.Gaussian(8.0, 1.0)
    fit = runs(lambda: tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=False), 4)
    mll = runs(lambda: lk.mll_value_and_grad(bench_k, Xb, Yb, 0.1), 3)
    out.append(f"narrow bench fit n={n}: {med(fit)}; narrow MLL value + gradient: {med(mll)}")
    for line in out:
        print(f"{label}: {line}", flush=True)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        torch.save(saved, os.path.join(outdir, f"{label}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
