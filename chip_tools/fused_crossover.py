#!/usr/bin/env python3
"""Where the fused fleet (route fleet-fused, one K9 launch per fit) stops
beating the panel-stepped fleet (route fleet-crout), on one CUDA card.

    python3 chip_tools/fused_crossover.py

Gaussian(2, 1), sigma 0.1, d=8, q=4, data from numpy's generator with seed
12.  For B = 128 and 256 and n = 128 ... 1024 (multiples of 128) it times
fit_batched on both routes in turns (CUDA events, order reversed every
round, 8 rounds after a warm-up) and prints the medians in ms and fits/s.
Then K9 alone at each size, and one K8 launch on (B, 64, 64) tiles: a
member's n / 64 diagonal steps (factor and inverse) are the part of K9 that
no other member's work can hide.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import batched as fops
    from gpr_tpu_torch.ops import crout
    from gpr_tpu_torch.ops import gram as gop

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    k = tg.Gaussian(2.0, 1.0)
    sig2 = float(np.float32(0.1)) ** 2

    def timed(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def rotate(fns, rounds=8):
        for fn in fns.values():
            fn()
        runs = {name: [] for name in fns}
        names = list(fns)
        for i in range(rounds):
            for name in (names if i % 2 == 0 else names[::-1]):
                runs[name].append(timed(fns[name]))
        return {name: float(np.median(r)) for name, r in runs.items()}

    def fit_at(max_n, X, Y):
        fops._FLEET_FUSED_MAX_N = max_n
        try:
            gp = tg.fit_batched(k, X, Y, 0.1)
        finally:
            fops._FLEET_FUSED_MAX_N = 0
        return gp

    for B in (128, 256):
        for n in range(128, 1025, 128):
            X = torch.tensor(rng.standard_normal((B, n, 8)), dtype=torch.float32, device=dev)
            Y = torch.tensor(rng.standard_normal((B, n, 4)), dtype=torch.float32, device=dev)
            assert fit_at(1024, X, Y).route == "fleet-fused" and fit_at(0, X, Y).route == "fleet-crout"
            t = rotate({"fused": lambda: fit_at(1024, X, Y), "panel": lambda: fit_at(0, X, Y)})
            P = torch.tensor(np.tile([2.0, 1.0, 1.0, sig2], (B, 1)), dtype=torch.float32, device=dev)
            K = gop.gram_batched(X, P)
            D = K[:, :64, :64].contiguous()
            t9 = rotate({"k9": lambda: fops.factor_solve_fused(K, Y),
                         "k8": lambda: crout.crout_chol_wi(D)})
            print(f"B={B} n={n}: fused fit {t['fused']:.3f} ms = {B / t['fused'] * 1e3:.0f} fits/s; "
                  f"panel-stepped {t['panel']:.3f} ms = {B / t['panel'] * 1e3:.0f} fits/s; "
                  f"ratio {t['panel'] / t['fused']:.2f}; K9 alone {t9['k9']:.3f} ms; "
                  f"{n // 64} diagonal steps ~{n // 64 * t9['k8']:.3f} ms (K8 on ({B}, 64, 64): "
                  f"{t9['k8']:.4f} ms)", flush=True)
            del X, Y, K, D, P
    return 0


if __name__ == "__main__":
    sys.exit(main())
