#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (gpr_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the hand-written kernels from gpr_tpu_torch/csrc with nvcc, then:

  1. holds each kernel (K1 gram_tile, K2 panel_update, K3 diag_factor_inv,
     K4 panel_solve) against its plain torch version on the card: small
     ragged shapes, the contracts of the fused factorization, and each kernel
     at the shapes the n=16384 fit gives it;
  2. fits the bench model, Gaussian(8, 1) with sigma 0.1 at n=16384, d=128,
     q=8 (route "fused-gram"), and predicts mean and credible interval at
     1024 points;
  3. fits the model of __graft_entry__.entry(), Sum(Gaussian(1.5, 1), White(0.1)), at
     n=4096, d=8, q=4 (route "fused-matrix") and predicts at 64 points;
  4. fits at unaligned n: 3773 (Gram mode with pad masking) and 384 (route
     "gram-kernel");
  5. runs the reference's sinus gate;
  6. times the n=16384 fit against the plain torch fit, and each kernel's
     total per fit against its plain version's.

Phases 2-4 hold the port's mean and credible interval against a float64
torch reference and pass when the port's error is at most 3x that of the
plain float32 torch route (torch Gram, torch.linalg.cholesky,
cholesky_solve).  The launch counters are reset before phase 2 and read
after phase 5: each kernel must have been launched there.  Any failure
raises.  The last two lines are the card's name and power limit, then one
JSON object with the device; the line before them lists the kernels.
Exits non-zero, printing no result, where there is no CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def relerr(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import _cuda, fullchol
    from gpr_tpu_torch.ops import gram as gop

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _cuda.build()
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
        if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
            print("  ptxas:", line.strip())

    def t32(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    kstats = {}

    # ---------------------------------------------------------------- 1 ----
    rng = np.random.default_rng(3)
    worst = 0.0
    for form in gop.FORMS:
        for tril in (False, True):
            n, m, d = 200, (200 if tril else 150), 37
            X = t32(rng.standard_normal((n, d)))
            Y = X if tril else t32(rng.standard_normal((m, d)))
            args = (X, Y, 1.7, 1.2, 0.7 if form == "periodic" else 2.0, 0.37)
            K = gop.gram(*args, form=form, tril=tril)
            R = gop.gram_reference(*args, form=form, tril=tril)
            if tril:
                K, R = torch.tril(K), torch.tril(R)
            err = float((K - R).abs().max()) / (float(R.abs().max()) if form == "sqdist" else 1.44)
            # d2's float32 cancellation near the diagonal is ~1e-7 |x|^2 and
            # dk/dd2 <= 1.5 scale^2 / sigma^2; matern12's sqrt(d2) cusp turns
            # it into sqrt(1e-7 |x|^2)
            check(err <= (1e-2 if form == "matern12" else 3e-5), f"K1 {form} tril={tril}: {err}")
            worst = max(worst, err) if form != "matern12" else worst
    torch.cuda.synchronize()
    print(f"phase 1a K1 gram_tile: 7 forms x (full, tril) at n=200 m=150 d=37 ok; "
          f"worst smooth-form error {worst:.3g} of scale^2")

    for n in (128, 384):
        B = rng.standard_normal((n, n))
        A = t32(B @ B.T + n * np.eye(n))
        An = A.clone()
        An[torch.triu(torch.ones_like(A, dtype=torch.bool), 1)] = float("nan")
        L = fullchol.cholesky_fused(An)
        Lr, _ = fullchol.fused_cholesky_reference(A)
        e = relerr(L, Lr)
        check(e < 1e-4, f"matrix mode n={n}: {e}")
        check(bool(torch.all(torch.triu(L, 1) == 0)), f"matrix mode n={n}: strict upper not 0")
    for n in (128, 300, 512):
        X = t32(rng.standard_normal((n, 5)))
        L, W = fullchol.gram_cholesky_fused(X, 1.3, 2.1, 1.0, 0.7, return_winv=True)
        Lr, Wr = fullchol.fused_cholesky_reference(X, form="gaussian", sigma=1.3, scale=2.1,
                                                   diag=0.7)
        check(relerr(L, Lr) < 1e-4 and relerr(W, Wr) < 1e-4, f"gram mode n={n}")
        eye = torch.eye(128, device=dev)
        for j in range(W.shape[0]):
            Ljj = L[j * 128:(j + 1) * 128, j * 128:(j + 1) * 128]
            check(float((W[j] @ Ljj - eye).abs().max()) < 1e-4, f"W_j L_jj != I, n={n} j={j}")
        check(bool(torch.all(L[n:, :n] == 0) and torch.all(torch.triu(L, 1) == 0)),
              f"gram mode n={n}: pad block or strict upper not 0")
    for where in (3, 380):
        B = rng.standard_normal((384, 384))
        A = B @ B.T + 384 * np.eye(384)
        A[where, where] = -1e6
        check(not bool(torch.isfinite(fullchol.cholesky_fused(t32(A))[-1, -1])),
              f"failed pivot at {where} did not poison L[-1,-1]")
    torch.cuda.synchronize()
    print("phase 1b K2-K4: aligned, padded, single panel, lower-only read, "
          "failed pivot (first and last panel), W_j L_jj = I: ok")

    # each kernel at the shapes the n=16384 fit gives it
    n, d, q = 16384, 128, 8
    rng0 = np.random.default_rng(0)
    Xb = t32(rng0.standard_normal((n, d)))
    Yb = t32(rng0.standard_normal((n, q)))
    Xt = t32(np.random.default_rng(1).standard_normal((1024, d)))
    gram_args = ("gaussian", 8.0, 1.0, 1.0, float(np.float32(0.1) ** 2))
    nc = n // fullchol.PANEL
    L = torch.empty((n, n), dtype=torch.float32, device=dev)
    W = torch.empty((nc, 128, 128), dtype=torch.float32, device=dev)
    j0 = nc // 2
    for j in range(j0):
        fullchol.panel_update(L, j, Xb, *gram_args)
        fullchol.diag_factor_inv(L, W, j)
        fullchol.panel_solve(L, W, j)
    cols = slice(j0 * 128, (j0 + 1) * 128)
    Lref = L.clone()
    fullchol.panel_update(L, j0, Xb, *gram_args)
    fullchol.panel_update_reference(Lref, j0, Xb, *gram_args)
    kstats["panel_update"] = {"max_abs_err": float((L[:, cols] - Lref[:, cols]).abs().max())}
    Lref.copy_(L)
    Wref = W.clone()
    fullchol.diag_factor_inv(L, W, j0)
    fullchol.diag_factor_inv_reference(Lref, Wref, j0)
    kstats["diag_factor_inv"] = {"max_abs_err": max(
        float((L[cols, cols] - Lref[cols, cols]).abs().max()),
        float((W[j0] - Wref[j0]).abs().max()))}
    Lref.copy_(L)
    fullchol.panel_solve(L, W, j0)
    fullchol.panel_solve_reference(Lref, W, j0)
    kstats["panel_solve"] = {"max_abs_err": float((L[:, cols] - Lref[:, cols]).abs().max())}
    Xg = Xb[:384].contiguous()
    K1 = gop.gram(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])
    kstats["gram_tile"] = {"max_abs_err": float(
        (K1 - gop.gram_reference(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])).abs().max())}
    del L, Lref, W, Wref
    torch.cuda.synchronize()
    for name, tol in (("gram_tile", 1e-5), ("panel_update", 1e-4), ("diag_factor_inv", 1e-3),
                      ("panel_solve", 1e-4)):
        e = kstats[name]["max_abs_err"]
        check(e <= tol, f"{name} at the n=16384 shapes: max abs err {e} > {tol}")
    print("phase 1c each kernel at the n=16384 fit's shapes (panel j=%d): %s" % (
        j0, ", ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in kstats.items())))

    # -------------------------------------------------------- references ---
    def gaussian64(A, B, sigma, scale):
        d2 = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * (A @ B.T)
        return scale * scale * torch.exp(-0.5 * d2.clamp(min=0.0) / (sigma * sigma))

    def plain_gp(X, Y, Xs, kfun, kss, sigma):
        """Mean and credible interval of the straightforward exact GP in the
        dtype of X: torch Gram, torch.linalg.cholesky, cholesky_solve."""
        K = kfun(X, X)
        K.diagonal().add_(sigma * sigma)
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(Y, L)
        Ks = kfun(Xs, X)
        var = kss - (Ks * torch.cholesky_solve(Ks.T, L).T).sum(1)
        return Ks @ alpha, 2.0 * torch.sqrt(var.clamp(min=0.0)), alpha, K

    def judge(name, gp, X, Y, Xs, kfun, kss, sigma):
        mean = gp.predict(Xs)
        ci = gp.credible_interval(Xs)
        check(mean.shape == (Xs.shape[0], Y.shape[1]) and ci.shape == (Xs.shape[0],),
              f"{name}: output shapes")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(ci).all()), f"{name}: non-finite")
        m64, c64, _, K64 = plain_gp(X.double(), Y.double(), Xs.double(), kfun, kss, sigma)
        m32, c32, _, _ = plain_gp(X, Y, Xs, kfun, kss, sigma)
        e_m, e_c = relerr(mean, m64), relerr(ci, c64)
        p_m, p_c = relerr(m32, m64), relerr(c32, c64)
        res = float((K64 @ gp.alpha.double() - Y.double()).norm() / Y.double().norm())
        print(f"  {name}: route {gp.route}; rel err vs f64: mean {e_m:.3g} (plain f32 {p_m:.3g}), "
              f"credible interval {e_c:.3g} (plain f32 {p_c:.3g}); residual |(K+s^2I)a-Y|/|Y| "
              f"{res:.3g}")
        check(e_m <= 3 * p_m and e_c <= 3 * p_c, f"{name}: error above 3x the plain f32 route's")
        del K64

    sig = float(np.float32(0.1))

    # ---------------------------------------------------------------- 2 ----
    _cuda.reset_launch_counts()
    bench_k = tg.Gaussian(8.0, 1.0)
    gp = tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)
    check(gp.route == "fused-gram", f"bench fit took route {gp.route}")
    torch.cuda.synchronize()
    print("phase 2 slice at full size: n=16384 d=128 q=8, 1024 test points")
    judge("bench Gaussian(8,1)", gp, Xb, Yb, Xt, lambda A, B: gaussian64(A, B, 8.0, 1.0),
          1.0, sig)
    del gp

    # ---------------------------------------------------------------- 3 ----
    n3, d3, q3 = 4096, 8, 4
    r3 = np.random.default_rng(0)  # __graft_entry__._make_dataset's seeds
    X3 = r3.standard_normal((n3, d3)).astype(np.float32)
    Y3 = (np.sin(X3.sum(axis=1, keepdims=True)) + 0.1 * r3.standard_normal((n3, q3)))
    Xs3 = np.random.default_rng(1).standard_normal((64, d3)).astype(np.float32)
    check(len(np.unique(X3, axis=0)) == n3, "entry data rows must be distinct")
    X3, Y3, Xs3 = t32(X3), t32(Y3), t32(Xs3)
    entry_k = tg.Sum(tg.Gaussian(1.5, 1.0), tg.White(0.1))
    gp = tg.fit(entry_k, X3, Y3, sigma=0.1)
    check(gp.route == "fused-matrix", f"entry fit took route {gp.route}")

    def entry64(A, B):  # distinct rows: White adds its 0.01 on the diagonal of K(X, X) only
        K = gaussian64(A, B, 1.5, 1.0)
        if A is B:
            K.diagonal().add_(0.01)
        return K

    torch.cuda.synchronize()
    print("phase 3 entry model in matrix mode: n=4096 d=8 q=4, 64 test points")
    judge("entry Sum(Gaussian,White)", gp, X3, Y3, Xs3, entry64, 1.01, sig)

    # ---------------------------------------------------------------- 4 ----
    print("phase 4 unaligned n")
    r4 = np.random.default_rng(4)
    X4 = t32(r4.standard_normal((3773, 5)))
    Y4 = t32(np.sin(r4.standard_normal((3773, 3))) + 0.1 * r4.standard_normal((3773, 3)))
    Xs4 = t32(r4.standard_normal((256, 5)))
    k4 = tg.Gaussian(2.0, 1.0)
    gp = tg.fit(k4, X4, Y4, sigma=0.1, use_pallas_gram=True)
    check(gp.route == "fused-gram" and gp.L.shape == (3773, 3773), "n=3773 route / factor shape")
    judge("n=3773 d=5 q=3 (pad to 3840)", gp, X4, Y4, Xs4,
          lambda A, B: gaussian64(A, B, 2.0, 1.0), 1.0, sig)
    gp = tg.fit(bench_k, Xb[:384], Yb[:384], sigma=0.1, use_pallas_gram=True)
    check(gp.route == "gram-kernel", f"n=384 fit took route {gp.route}")
    judge("n=384 d=128 q=8", gp, Xb[:384], Yb[:384], Xt[:64],
          lambda A, B: gaussian64(A, B, 8.0, 1.0), 1.0, sig)

    # ---------------------------------------------------------------- 5 ----
    xs = torch.tensor(np.arange(10) * 2 * math.pi / 10, dtype=torch.float64, device=dev)
    xt = torch.tensor(np.arange(50) * 2 * math.pi / 50, dtype=torch.float64, device=dev)
    gp = tg.fit(tg.Gaussian(2.889), xs[:, None], torch.sin(xs)[:, None], sigma=0.0)
    err = float((gp.predict(xt[:, None])[:, 0] - torch.sin(xt)).abs().sum())
    check(err < 0.0008, f"sinus gate: {err}")
    torch.cuda.synchronize()
    print(f"phase 5 sinus gate on CUDA (float64): sum |err| = {err:.3g} < 0.0008 ok")

    counts = _cuda.launch_counts()
    print(f"launches on the main path (phases 2-5): {counts}")
    check(all(v > 0 for v in counts.values()), "a kernel of the path was never launched")

    # ---------------------------------------------------------------- 6 ----
    def ev():
        return torch.cuda.Event(enable_timing=True)

    def timed(fn):
        a, b = ev(), ev()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def port_fit():
        tg.fit(bench_k, Xb, Yb, sigma=0.1, use_pallas_gram=True)

    def plain_fit():
        K = gaussian64(Xb, Xb, 8.0, 1.0)
        K.diagonal().add_(sig * sig)
        torch.cholesky_solve(Yb, torch.linalg.cholesky(K))

    port_fit(), plain_fit()  # warm-up
    t_port, t_plain = [], []
    for i in range(6):
        order = (plain_fit, port_fit) if i % 2 == 0 else (port_fit, plain_fit)
        for fn in order:
            (t_port if fn is port_fit else t_plain).append(timed(fn))
    med_port, med_plain = float(np.median(t_port)), float(np.median(t_plain))

    def per_kernel(steps):
        update, factor_inv, solve = steps
        tot = [0.0, 0.0, 0.0]
        L = torch.empty((n, n), dtype=torch.float32, device=dev)
        W = torch.empty((nc, 128, 128), dtype=torch.float32, device=dev)
        for j in range(nc):
            tot[0] += timed(lambda: update(L, j, Xb, *gram_args))
            tot[1] += timed(lambda: factor_inv(L, W, j))
            if j + 1 < nc:
                tot[2] += timed(lambda: solve(L, W, j))
        check(bool(torch.isfinite(L[-1, -1])), "timed factorization failed")
        return tot

    ker = per_kernel((fullchol.panel_update, fullchol.diag_factor_inv, fullchol.panel_solve))
    ref = per_kernel((fullchol.panel_update_reference, fullchol.diag_factor_inv_reference,
                      fullchol.panel_solve_reference))
    for name, k_ms, p_ms in zip(("panel_update", "diag_factor_inv", "panel_solve"), ker, ref):
        kstats[name].update(ms=k_ms, plain_ms=p_ms)

    def median_ms(fn, reps=20):
        fn()
        return float(np.median([timed(fn) for _ in range(reps)]))

    kstats["gram_tile"].update(
        ms=median_ms(lambda: gop.gram(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])),
        plain_ms=median_ms(lambda: gop.gram_reference(Xg, Xg, 8.0, 1.0, 1.0, gram_args[4])),
    )
    big_ms = median_ms(lambda: gop.gram(Xb, Xb, 8.0, 1.0, 1.0, gram_args[4], tril=True), 5)
    big_plain = median_ms(lambda: gop.gram_reference(Xb, Xb, 8.0, 1.0, 1.0, gram_args[4]), 5)
    print(f"phase 6 timings ({smi}), CUDA events, medians:")
    print(f"  fit n=16384 d=128 q=8: hand-written route {med_port:.2f} ms "
          f"(runs {', '.join(f'{t:.1f}' for t in t_port)}); plain torch route {med_plain:.2f} ms "
          f"(runs {', '.join(f'{t:.1f}' for t in t_plain)})")
    print(f"  per fit at n=16384: K2 panel_update {ker[0]:.2f} ms (plain {ref[0]:.2f}), "
          f"K3 diag_factor_inv {ker[1]:.2f} ms (plain {ref[1]:.2f}), "
          f"K4 panel_solve {ker[2]:.2f} ms (plain {ref[2]:.2f}); sum of per-launch events")
    print(f"  K1 gram_tile n=384 d=128: {kstats['gram_tile']['ms']:.4f} ms "
          f"(plain {kstats['gram_tile']['plain_ms']:.4f}); n=16384 d=128 tril: {big_ms:.2f} ms "
          f"(plain full {big_plain:.2f})")

    sources = {"gram_tile": "gpr_tpu_torch/csrc/gram.cu"}
    replaces = {"gram_tile": "gpr_tpu/ops/pallas_gram.py:38"}
    kernels = []
    for k in _cuda.KERNELS:
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": sources.get(k.name, "gpr_tpu_torch/csrc/fullchol.cu"),
            "replaces": replaces.get(k.name, "gpr_tpu/ops/pallas_fullchol.py:722"),
            "launches": counts[k.name], **kstats[k.name],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
