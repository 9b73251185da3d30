#!/usr/bin/env python3
"""Time K19 (tile_chol) and K20 (tile_chol_strips, sw 8 and 16) for the
gpr_tpu_torch package under a given root, on one CUDA card, beside
torch.linalg.cholesky_ex on the same tile.

    python3 chip_tools/ab_k19_k20.py <root> <label>

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card to compare them, e.g. with the parent unpacked into the
gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in tmp_chip/parent . . tmp_chip/parent; do
        python3 chip_tools/ab_k19_k20.py $t $t; done

Prints one line per n = 256 and 512 (ms, CUDA events, median and runs of
10 after a warm-up): each call queued behind a device sleep, so that the
host's enqueue is not timed ("queued"), and each call with the host's time
to enqueue it, the wrapper's checks, its allocation of L and the ctypes
call ("enqueue"); the tile is G G^T / n + I (chip_smoke.py phase 25's).
"""

import os
import sys

from ab_harness import med, timed


def main() -> int:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import _cuda, chol

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)

    for n in (256, 512):
        G = torch.randn((n, n), generator=g, device=dev)
        A = G @ G.T / n
        A.diagonal().add_(1.0)
        fns = {"K19": lambda: chol.cholesky_tile(A),
               "K20 sw=8": lambda: chol.cholesky_tile_v2(A, sw=8),
               "K20 sw=16": lambda: chol.cholesky_tile_v2(A, sw=16),
               "cholesky_ex": lambda: torch.linalg.cholesky_ex(A)}
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
        print(f"{label} n={n}: " + " | ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
