#!/usr/bin/env python3
"""Time K12 (leaf_chol) and K15 (panel_factor) for the gpr_tpu_torch package
under a given root, on one CUDA card, beside their library calls.

    python3 chip_tools/ab_k12_k15.py <root> <label>

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card to compare them, e.g. with the parent unpacked into the
gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in tmp_chip/parent . . tmp_chip/parent; do
        python3 chip_tools/ab_k12_k15.py $t $t; done

Prints, in ms (CUDA events, median and runs after a warm-up):
- K12 per leaf at s = 256, 512 and 1024 against torch.linalg.cholesky_ex on
  the same leaf (G G^T / s + I, as chip_smoke.py phase 18's), 10 rounds in
  turns: each call queued behind a device sleep, so that the host's enqueue
  is not timed ("queued"), then each call with the host's time to enqueue it
  ("enqueue");
- K15 summed over the 32 panels of cholesky_left_panels at n = 8192 (the
  panels of G G^T / n + I, each corrected by the factored columns, as the
  schedule meets them), each call queued, against cholesky_ex +
  solve_triangular on the same panels, 5 walks in turns; then one walk under
  torch.profiler: the device time of each kernel that K15 launches, summed
  over the 32 panels (its diagonal tile's kernel and its rows' kernel).
"""

import os
import sys

from ab_harness import med, timed


def main() -> int:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import _cuda, leaf, panel

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
        fns = {"K12": lambda: leaf.leaf_cholesky(A), "cholesky_ex": lambda: torch.linalg.cholesky_ex(A)}
        out = []
        for sleep in (True, False):
            runs = {k: [] for k in fns}
            for fn in fns.values():
                fn()
            for i in range(10):  # in turns, the order reversed every round
                for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
                    runs[k].append(timed(fns[k], sleep))
            out.append(("queued" if sleep else "enqueue") + ": "
                       + "; ".join(f"{k} {med(v)}" for k, v in runs.items()))
        print(f"{label} K12 s={s}: " + " | ".join(out), flush=True)

    n = 8192
    A = spd(n)
    L = torch.zeros_like(A)
    panels = []
    for k in range(n // 256):
        j0 = k * 256
        P = A[j0:, j0:j0 + 256]
        if k > 0:
            P = P - L[j0:, :j0] @ L[j0:j0 + 256, :j0].mT
        panels.append(P)
        L[j0:, j0:j0 + 256] = panel.panel_factor(P)
    if not bool(torch.isfinite(L[-1, -1])):
        raise RuntimeError("the left-looking panels failed")

    def lib(P):
        Lk = torch.linalg.cholesky_ex(P[:256])[0]
        return torch.linalg.solve_triangular(Lk.mT, P[256:], upper=True, left=False)

    fns = {"K15": panel.panel_factor, "cholesky_ex + solve_triangular": lib}
    walks = {k: [] for k in fns}
    for i in range(5):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            walks[k].append(sum(timed(lambda: fns[k](P), True) for P in panels))
    print(f"{label} K15 per n={n} cholesky_left_panels (32 panels, queued): "
          + "; ".join(f"{k} {med(v)}" for k, v in walks.items()), flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for P in panels:
            panel.panel_factor(P)
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
            key = e.name.split("(")[0].replace("void ", "").replace("gpr::", "")
            t, c = per.get(key, (0.0, 0))
            per[key] = (t + (e.time_range.end - e.time_range.start) / 1e3, c + 1)
    print(f"{label} K15 split (torch.profiler, device ms over the 32 panels): "
          + "; ".join(f"{k} {t:.4f} ({c} launches)" for k, (t, c) in sorted(per.items())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
