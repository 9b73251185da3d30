#!/usr/bin/env python3
"""Time K2 (panel_update), K3 (diag_factor_inv) and K4 (panel_solve) per
fit, the fused-gram fit at n=16384, d=128, q=8 and the MLL value + gradient
there (route fused-matrix), and K5 (syrk_update) per n=16383 blocked
factorization and the MLL value + gradient at n=16383 (route blocked-syrk)
for the gpr_tpu_torch package under a given root, on one CUDA card.

    python3 chip_tools/ab_panel_update.py <root> <label> [--fits N]

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card to compare them, e.g. with the parent unpacked into the
gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in tmp_chip/parent . . tmp_chip/parent; do
        python3 chip_tools/ab_panel_update.py $t $t; done

Prints one line: each kernel's total per fit (sum of per-launch CUDA events)
for 3 factorizations, 4 fit times and 3 MLL times (the first of each
includes the warm-up), in ms; one line with K5's total per n=16383
factorization (sum of per-launch events over the recursion's trailing
updates) for 3 factorizations, per factorization at the breathing shape
(n=3773, d=5) for 5, and 3 MLL times at n=16383; then the device
time of each CUDA kernel in one fit from a torch.profiler trace.  Each timed launch is queued behind a
short device sleep, so that its events time the kernel and not the host's
time to enqueue it.

With --fits N it prints instead N fit times and N times of the fused-gram
factorization alone (CUDA events, after one warm-up of each), with the
host's time to enqueue each factorization (to the return of the call,
which does not wait for the card): where that is shorter than the device's
time, the host does not hold the card back.
"""

import os
import sys

import numpy as np

from ab_harness import timed


def main() -> int:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.gp import likelihood as lk
    from gpr_tpu_torch.ops import _cuda, blocked, fullchol

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    n, d, q, panel = 16384, 128, 8, 128
    rng0 = np.random.default_rng(0)
    Xb = torch.tensor(rng0.standard_normal((n, d)), dtype=torch.float32, device=dev)
    Yb = torch.tensor(rng0.standard_normal((n, q)), dtype=torch.float32, device=dev)
    args = ("gaussian", 8.0, 1.0, 1.0, float(np.float32(0.1) ** 2))
    if "--fits" in sys.argv:
        count = int(sys.argv[sys.argv.index("--fits") + 1])
        return fits_only(tg, fullchol, label, count, Xb, Yb, args)

    nc = n // panel
    per_fit = {"K2": [], "K3": [], "K4": []}
    for _ in range(3):
        L = torch.empty((n, n), device=dev)
        W = torch.empty((nc, panel, panel), device=dev)
        tot = [0.0, 0.0, 0.0]
        for j in range(nc):
            tot[0] += timed(lambda: fullchol.panel_update(L, j, Xb, *args), True)
            tot[1] += timed(lambda: fullchol.diag_factor_inv(L, W, j), True)
            if j + 1 < nc:
                tot[2] += timed(lambda: fullchol.panel_solve(L, W, j), True)
        if not torch.isfinite(L[-1, -1]):
            raise RuntimeError("the timed factorization failed")
        for name, t in zip(per_fit, tot):
            per_fit[name].append(t)
        del L, W
    fit = [timed(lambda: tg.fit(tg.Gaussian(8.0, 1.0), Xb, Yb, sigma=0.1, use_pallas_gram=True))
           for _ in range(4)]
    mll = [timed(lambda: lk.mll_value_and_grad(tg.Gaussian(8.0, 1.0), Xb, Yb, 0.1))
           for _ in range(3)]
    torch.cuda.empty_cache()
    parts = "; ".join(f"{k} per fit {[round(x, 2) for x in v]} ms" for k, v in per_fit.items())
    print(f"{label}: {parts}; fit {[round(x, 2) for x in fit]} ms; "
          f"MLL value + gradient {[round(x, 2) for x in mll]} ms", flush=True)

    # K5 per blocked factorization at n=16383 and at the breathing shape
    # (n=3773, d=5, Gaussian(2, 1)): each trailing update timed alone
    def gram(X, sigma):
        sq = (X * X).sum(1)
        K = torch.exp(-0.5 * (sq[:, None] + sq[None, :] - 2.0 * X @ X.T).clamp(min=0.0) / sigma ** 2)
        K.diagonal().add_(args[4])
        return K

    orig = blocked.syrk_update

    def k5_per_factorization(K):
        tot = [0.0]

        def timed_update(A22, L21, out):
            tot[0] += timed(lambda: orig(A22, L21, out=out))
            return out

        blocked.syrk_update = timed_update
        try:
            L = blocked.cholesky_blocked(K)
        finally:
            blocked.syrk_update = orig
        if not torch.isfinite(L[-1, -1]):
            raise RuntimeError("the timed blocked factorization failed")
        return tot[0]

    X163, Y163 = Xb[:16383], Yb[:16383]
    K = gram(X163, 8.0)
    k5 = [k5_per_factorization(K) for _ in range(3)]
    X4 = torch.tensor(np.random.default_rng(4).standard_normal((3773, 5)), dtype=torch.float32,
                      device=dev)  # chip_smoke.py phase 4's data
    K = gram(X4, 2.0)
    k5_3773 = [k5_per_factorization(K) for _ in range(5)]
    del K
    torch.cuda.empty_cache()
    mll163 = [timed(lambda: lk.mll_value_and_grad(tg.Gaussian(8.0, 1.0), X163, Y163, 0.1))
              for _ in range(3)]
    torch.cuda.empty_cache()
    print(f"{label}: K5 per n=16383 factorization {[round(x, 2) for x in k5]} ms; per n=3773 "
          f"factorization {[round(x, 3) for x in k5_3773]} ms; MLL value + gradient n=16383 "
          f"{[round(x, 2) for x in mll163]} ms", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tg.fit(tg.Gaussian(8.0, 1.0), Xb, Yb, sigma=0.1, use_pallas_gram=True)
        torch.cuda.synchronize()
    dev_ms = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms[e.key[:60]] = (us / 1e3, e.count)
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"{label}: profiled fit, device ms (launches): "
          + "; ".join(f"{k} {v[0]:.2f} ({v[1]})" for k, v in top), flush=True)
    return 0


def fits_only(tg, fullchol, label, count, Xb, Yb, args) -> int:
    import time

    import torch

    def fit():
        tg.fit(tg.Gaussian(8.0, 1.0), Xb, Yb, sigma=0.1, use_pallas_gram=True)

    def factor():
        fullchol.gram_cholesky_fused(Xb, *args[1:], form=args[0])

    out = {}
    for name, fn in (("fit", fit), ("factorization", factor)):
        fn()
        torch.cuda.synchronize()
        dev_ms, host_ms = [], []
        for _ in range(count):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            fn()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            b.record()
            b.synchronize()
            dev_ms.append(a.elapsed_time(b))
        out[name] = (dev_ms, host_ms)
    text = []
    for name, (dev_ms, host_ms) in out.items():
        text.append(f"{name} median {np.median(dev_ms):.2f} ms (min {min(dev_ms):.2f}, max "
                    f"{max(dev_ms):.2f}), host to return {np.median(host_ms):.2f}")
    print(f"{label}: {count} each: " + "; ".join(text), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
