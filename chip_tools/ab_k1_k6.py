#!/usr/bin/env python3
"""Time K1 (gram_tile) and K6 (gram_batched) for the gpr_tpu_torch package
under a given root, on one CUDA card, with the paths that run them and the
kernels that share their tile headers, and save their outputs so that two
trees can be compared bit for bit.

    python3 chip_tools/ab_k1_k6.py <root> <label> [<outdir>]
    python3 chip_tools/ab_k1_k6.py --compare <a.pt> <b.pt>

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card, then compare their saved outputs, e.g. with the parent
unpacked into the gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in parent:tmp_chip/parent change:. change2:. parent2:tmp_chip/parent; do
        python3 chip_tools/ab_k1_k6.py ${t#*:} ${t%%:*} tmp_chip/ab; done
    python3 chip_tools/ab_k1_k6.py --compare tmp_chip/ab/parent.pt tmp_chip/ab/change.pt

Prints (ms, CUDA events, median and runs; the first run of each is a
warm-up and is dropped):
  * K6 on benchmarks/bench_batched.py's data (Gaussian(2, 1), sigma 0.1,
    d = 8) at B=128, n=512 and B=256, n=1024, queued behind a device sleep
    and with the host's enqueue, beside the torch composition (batched
    torch.cdist, square, scale, exp and the diagonal: 5 calls); the fused and
    the panel-stepped fleet fit at B=128, n=512 (with the host's enqueue);
  * K1 on the bench data (Gaussian(8, 1), d = 128) at n=384 (the gram-kernel
    route's full square) and n=16384 (lower triangle), queued and with the
    host's enqueue, beside the torch composition (torch.cdist, the epilogue,
    the diagonal: 5 calls), and at n=16384 for matern12 (the FP32 path);
    each tensor-core form's largest error against a float64 Gram; the bench
    fit under GPR_CHOL_SCHEDULE=recursive + GPR_CHOL_LEAF_INV=1 and under
    GPR_CHOL_SCHEDULE=inplace (both build K with K1);
  * the kernels that share gram_tile.cuh and tc_tile.cuh, queued: the bench
    factorization K2-K4 (gram_cholesky_fused, with the host's enqueue), K5
    at (m, k) = (8191, 8192), K14 on a 1024 leaf, K16 per n=8192 in-place
    walk.
Saved: K6 on every form (B=32, n=512, d=8 and B=3, n=200, d=37, per-member
parameters), K1's FP32 path (matern12 and periodic at n=1000, d=128, lower
triangle; gaussian at d=37 full and lower triangle), K1's tensor-core forms
at n=1000, d=128 (these differ from a tree with the FP32 cross term), K2-K4,
K5, K14 and K16's outputs; the largest outputs as sha256 digests.
--compare prints, for every saved output, whether the two trees' are equal
bit for bit, else the largest difference relative to the largest entry.
"""

import hashlib
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
    from gpr_tpu_torch.ops import _cuda, fullchol, inplace_chol, leaf, syrk
    from gpr_tpu_torch.ops import batched as fbatched
    from gpr_tpu_torch.ops import gram as gop

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    saved = {}

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()

    def t32(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    out = []
    sig = float(np.float32(0.1))

    # ---- K6
    def k6_library(X, sigma, diag):
        """The torch composition of the fleet's Gaussian Gram: 5 calls."""
        d2 = torch.cdist(X, X).square_()
        K = d2.mul_(-0.5 / (sigma * sigma)).exp_()
        K.diagonal(dim1=1, dim2=2).add_(diag)
        return K

    for B, n in ((128, 512), (256, 1024)):
        r = np.random.default_rng(0)  # benchmarks/bench_batched.py:31-34
        X = t32(r.standard_normal((B, n, 8)))
        P = t32(np.tile([2.0, 1.0, 1.0, sig * sig], (B, 1)))
        saved[f"K6 B={B} n={n} gaussian"] = digest(gop.gram_batched(X, P))
        out.append(f"K6 B={B} n={n} d=8 (queued): {med(runs(lambda: gop.gram_batched(X, P), 10, True))}; "
                   f"with the host's enqueue {med(runs(lambda: gop.gram_batched(X, P), 10))}; torch "
                   f"composition (5 calls, queued) {med(runs(lambda: k6_library(X, 2.0, sig * sig), 10, True))}")
        if n == 512:
            Y = t32(r.standard_normal((B, n, 4)))
            k_f = tg.Gaussian(2.0, 1.0)

            def fit_at(max_n):
                saved_max = fbatched._FLEET_FUSED_MAX_N
                fbatched._FLEET_FUSED_MAX_N = max_n
                try:
                    tg.fit_batched(k_f, X, Y, 0.1)
                finally:
                    fbatched._FLEET_FUSED_MAX_N = saved_max

            for name, mx in (("fused", 1024), ("panel-stepped", 0)):
                out.append(f"fleet fit {name} B={B} n={n} (with the host's enqueue): "
                           f"{med(runs(lambda: fit_at(mx), 10))}")
            del Y
        del X, P
    torch.cuda.empty_cache()
    g6 = np.random.default_rng(6)
    for B, n, d in ((32, 512, 8), (3, 200, 37)):
        X = t32(g6.standard_normal((B, n, d)))
        P = t32(np.stack([g6.uniform(1.0, 2.5, B), g6.uniform(0.8, 1.4, B), g6.uniform(0.5, 3.0, B),
                          g6.uniform(0.01, 0.4, B)], 1))
        for form in gop.FORMS:
            K = gop.gram_batched(X, P, form=form)
            saved[f"K6 B={B} n={n} d={d} {form}"] = K.cpu()
            sym = bool(torch.equal(K, K.mT))
            out.append(f"K6 B={B} n={n} d={d} {form}: exactly symmetric {sym}")

    # ---- K1
    r = np.random.default_rng(0)
    Xb = t32(r.standard_normal((16384, 128)))
    diag = sig * sig

    def k1_library(X, sigma):
        d2 = torch.cdist(X, X).square_()
        K = d2.mul_(-0.5 / (sigma * sigma)).exp_()
        K.diagonal().add_(diag)
        return K

    Xg = Xb[:384].contiguous()
    out.append(f"K1 n=384 d=128 full (queued): {med(runs(lambda: gop.gram(Xg, Xg, 8.0, 1.0, 1.0, diag), 20, True))}; "
               f"with the host's enqueue {med(runs(lambda: gop.gram(Xg, Xg, 8.0, 1.0, 1.0, diag), 20))}; "
               f"torch composition (queued) {med(runs(lambda: k1_library(Xg, 8.0), 20, True))}")
    out.append("K1 n=16384 d=128 tril (queued): "
               f"{med(runs(lambda: gop.gram(Xb, Xb, 8.0, 1.0, 1.0, diag, tril=True), 6, True))}; with the host's "
               f"enqueue {med(runs(lambda: gop.gram(Xb, Xb, 8.0, 1.0, 1.0, diag, tril=True), 6))}; torch "
               f"composition, full square (queued) {med(runs(lambda: k1_library(Xb, 8.0), 6, True))}")
    out.append("K1 n=16384 d=128 tril matern12 (FP32 path, queued): "
               f"{med(runs(lambda: gop.gram(Xb, Xb, 8.0, 1.0, 1.0, diag, form='matern12', tril=True), 4, True))}")
    # each form's error against a float64 Gram (lower triangle), at n=2048
    Xe = Xb[:2048].contiguous()
    X64 = Xe.double()
    low = torch.ones((2048, 2048), dtype=torch.bool, device=dev).tril_()
    errs = []
    for form in gop.FORMS:
        third = 0.7 if form == "periodic" else 2.0
        K = gop.gram(Xe, Xe, 8.0, 1.2, third, diag, form=form, tril=True)
        xx = (X64 * X64).sum(1)
        d2 = (xx[:, None] + xx[None, :] - 2.0 * X64 @ X64.T).clamp(min=0.0)
        if form == "periodic":
            d2 = sum((torch.sin(third * (X64[:, None, k] - X64[None, :, k])) ** 2) for k in range(128))
        R = gop.form_value(form, d2, 8.0, 1.2, third)
        R.diagonal().add_(diag)
        e = float((K.double() - R)[low].abs().max() / (R.abs().max() if form == "sqdist" else 1.44))
        errs.append(f"{form} {e:.3g}")
        del K, R, d2
    out.append("K1 n=2048 d=128 tril, max error against float64 (of scale^2; sqdist of its largest entry): "
               + ", ".join(errs))
    del Xe, X64, low
    Xs = Xb[:1000].contiguous()
    for form in gop.FORMS:
        third = 0.7 if form == "periodic" else 2.0
        saved[f"K1 n=1000 d=128 tril {form} (lower)"] = torch.tril(
            gop.gram(Xs, Xs, 8.0, 1.2, third, diag, form=form, tril=True)).cpu()
    X37 = t32(r.standard_normal((700, 37)))
    Y37 = t32(r.standard_normal((500, 37)))
    saved["K1 d=37 700x500 rq"] = gop.gram(X37, Y37, 1.7, 1.2, 2.0, 0.37, form="rq").cpu()
    saved["K1 d=37 700 tril gaussian (lower)"] = torch.tril(gop.gram(X37, X37, 1.7, 1.2, 2.0, 0.37, tril=True)).cpu()

    bench_k = tg.Gaussian(8.0, 1.0)
    Yb = t32(r.standard_normal((16384, 8)))
    for label_, env in (("recursive + leaf inverse", {"GPR_CHOL_SCHEDULE": "recursive", "GPR_CHOL_LEAF_INV": "1"}),
                        ("inplace", {"GPR_CHOL_SCHEDULE": "inplace"})):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            gp = tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)
            saved[f"bench fit {label_} alpha"] = gp.alpha.cpu()
            del gp
            fits = runs(lambda: tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True), 4)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out.append(f"bench fit n=16384 under {label_} (with the host's enqueue): {med(fits)}")
        torch.cuda.empty_cache()

    # ---- the kernels that share the tile headers
    Lb, Wb = fullchol.gram_cholesky_fused(Xb, 8.0, 1.0, 1.0, 0.01, return_winv=True)
    saved["K2-K4 n=16384 L"], saved["K2-K4 n=16384 W"] = digest(Lb), Wb.cpu()
    del Lb, Wb
    out.append("bench factorization n=16384 d=128, K2-K4 (with the host's enqueue): "
               f"{med(runs(lambda: fullchol.gram_cholesky_fused(Xb, 8.0, 1.0, 1.0, 0.01), 6))}")
    del Xb, Yb
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(5)
    m, k = 8191, 8192
    A22 = torch.randn((m, m), generator=g, device=dev)
    L21 = torch.randn((m, k), generator=g, device=dev) / k ** 0.5
    saved["K5 8191x8192"] = digest(torch.tril(syrk.syrk_update(A22, L21)))
    out.append(f"K5 m=8191 k=8192 (queued): {med(runs(lambda: syrk.syrk_update(A22, L21), 6, True))}")
    del A22, L21
    G = torch.randn((1024, 1024), generator=g, device=dev)
    A = G @ G.T / 1024 + torch.eye(1024, device=dev)
    L13 = torch.linalg.cholesky(A).contiguous()
    saved["K14 s=1024"] = leaf.tri_inv_leaf(L13).cpu()
    out.append(f"K14 s=1024 (queued): {med(runs(lambda: leaf.tri_inv_leaf(L13), 10, True))}")
    del G, A, L13
    n = 8192
    X8 = t32(np.random.default_rng(0).standard_normal((n, 128)))
    x8 = (X8 * X8).sum(1)
    K8 = (-0.5 * (x8[:, None] + x8[None, :] - 2.0 * (X8 @ X8.T)).clamp(min=0.0) / 64.0).exp()
    K8.diagonal().add_(sig * sig)
    del X8
    k16 = []
    for i in range(3):
        S = K8.clone()
        tot = 0.0
        for st in inplace_chol.schedule(n, 512, 256, dev):
            if st[0] == "panel":
                inplace_chol.panel_inplace(S, st[1])
            else:
                _, rows, cols, kcols, bm = st
                tot += timed(lambda: inplace_chol._rank_update_tiles(S, rows, cols, kcols, bm, bm), True)
        if i == 0:
            saved["K16 in-place walk n=8192"] = digest(torch.tril(S))
        else:
            k16.append(tot)
        del S
    out.append(f"K16 per n=8192 in-place walk (queued): {med(k16)}")
    for line in out:
        print(f"{label}: {line}", flush=True)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        torch.save(saved, os.path.join(outdir, f"{label}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
