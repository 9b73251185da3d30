#!/usr/bin/env python3
"""Time K14 (tri_inv_leaf) and K13 (leaf_chol_wi) for the gpr_tpu_torch
package under a given root, on one CUDA card, with the factorization that
runs K13 and K11 (diag_tri_inv), which shares their header, and save their
outputs so that two trees can be compared bit for bit.

    python3 chip_tools/ab_k14.py <root> <label> [<outdir>]
    python3 chip_tools/ab_k14.py --compare <a.pt> <b.pt>

<root> holds a gpr_tpu_torch/ directory (a checkout, or an older commit
unpacked with git archive).  Run it for two trees in turns (a, b, b, a) in
one run on one card, then compare their saved outputs, e.g. with the parent
unpacked into the gitignored tmp_chip/:

    git archive HEAD~1 | tar -x -C tmp_chip/parent
    for t in parent:tmp_chip/parent change:. change2:. parent2:tmp_chip/parent; do
        python3 chip_tools/ab_k14.py ${t#*:} ${t%%:*} tmp_chip/ab; done
    python3 chip_tools/ab_k14.py --compare tmp_chip/ab/parent.pt tmp_chip/ab/change.pt

Prints, in ms (CUDA events, median and runs after a warm-up, 10 rounds in
turns, the order reversed every round):
  * K14 per leaf at s = 256, 512, 768 and 1024 (the factor of G G^T / s + I,
    as chip_smoke.py phase 18's leaf) against torch.linalg.solve_triangular
    (L, I), each call queued behind a device sleep, so that the host's
    enqueue is not timed ("queued"), then with the host's time to enqueue it
    ("enqueue");
  * K13 per 1024-leaf the same way, against torch.linalg.cholesky_ex +
    solve_triangular(L, I), and one K13 and one K14 call at 1024 under
    torch.profiler: the device time of each kernel they launch;
  * K11 at n = 16384, bs = 512 on torch.linalg.cholesky's factor of the
    bench K (row-major), queued;
  * the n = 16384 factorization of the bench K (Gaussian(8, 1) of the bench's
    X, sigma 0.1) on blocked-syrk-leaf (GPR_CHOL_LEAF_INV=1: K13 on 16
    leaves), blocked-syrk and torch.linalg.cholesky, 5 rounds, each with the
    host's enqueue.
Saved: K14 at every s, K13's L and W at 1024, K11's output and the leaf
route's factor (a sha256 digest).  --compare prints, for every saved output,
whether the two trees' are equal bit for bit, else the largest difference
relative to the largest entry.
"""

import hashlib
import os
import sys

import numpy as np

from ab_harness import compare, device_split, rounds


def main() -> int:
    if sys.argv[1] == "--compare":
        return compare(sys.argv[2], sys.argv[3])
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    outdir = sys.argv[3] if len(sys.argv) > 3 else None
    sys.path.insert(0, root)
    import torch

    import gpr_tpu_torch as tg
    from gpr_tpu_torch.ops import _cuda, blocked, leaf, solve

    if not tg.__file__.startswith(root):
        raise RuntimeError(f"imported {tg.__file__}, not the tree under {root}")
    _cuda.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    saved = {}

    def spd(n):
        G = torch.randn((n, n), generator=g, device=dev)
        A = G @ G.T / n
        A.diagonal().add_(1.0)
        return A

    for s in (256, 512, 768, 1024):
        A = spd(s)
        L = torch.linalg.cholesky(A).contiguous()  # row-major, as the port's factors
        eye = torch.eye(s, device=dev)
        W = leaf.tri_inv_leaf(L)
        res = float((W @ L - eye).abs().max())
        if not res < 1e-4:
            raise RuntimeError(f"K14 s={s}: |W L - I| = {res}")
        saved[f"K14 s={s}"] = W.cpu()
        fns = {"K14": lambda: leaf.tri_inv_leaf(L),
               "solve_triangular": lambda: torch.linalg.solve_triangular(L, eye, upper=False)}
        print(f"{label} K14 s={s} (|WL-I| {res:.3g}): queued: {rounds(fns, 10, True)} | enqueue: "
              f"{rounds(fns, 10, False)}", flush=True)
    fns = {"K13": lambda: leaf.leaf_cholesky_wi(A),
           "cholesky_ex + solve_triangular": lambda: torch.linalg.solve_triangular(
               torch.linalg.cholesky_ex(A)[0], eye, upper=False)}
    print(f"{label} K13 s=1024: queued: {rounds(fns, 10, True)} | enqueue: {rounds(fns, 10, False)}", flush=True)
    saved["K13 s=1024 L"], saved["K13 s=1024 W"] = (M.cpu() for M in leaf.leaf_cholesky_wi(A))
    print(f"{label} K13 s=1024 split (torch.profiler, device ms): "
          + device_split(lambda: leaf.leaf_cholesky_wi(A)), flush=True)
    print(f"{label} K14 s=1024 split (torch.profiler, device ms): "
          + device_split(lambda: leaf.tri_inv_leaf(L)), flush=True)
    del A, L, W

    # the bench K at n = 16384
    n, d = 16384, 128
    X = torch.tensor(np.random.default_rng(0).standard_normal((n, d)), dtype=torch.float32, device=dev)
    d2 = (X * X).sum(1)[:, None] + (X * X).sum(1)[None, :] - 2.0 * (X @ X.T)
    K = (-0.5 * d2.clamp(min=0.0) / 64.0).exp()
    del d2
    K.diagonal().add_(float(np.float32(0.1)) ** 2)
    Lleaf = blocked.cholesky_blocked(K, leaf_inverse=True)
    if not bool(torch.isfinite(Lleaf[-1, -1])):
        raise RuntimeError("the leaf-route factorization failed")
    saved["blocked-syrk-leaf n=16384 L"] = hashlib.sha256(Lleaf.contiguous().cpu().numpy().tobytes()).hexdigest()
    facts = {"blocked-syrk-leaf": lambda: blocked.cholesky_blocked(K, leaf_inverse=True),
             "blocked-syrk": lambda: blocked.cholesky_blocked(K, leaf_inverse=False),
             "torch.linalg.cholesky": lambda: torch.linalg.cholesky(K)}
    print(f"{label} factorization n={n} (bench K, with the host's enqueue): {rounds(facts, 5, False)}", flush=True)
    Lc = torch.linalg.cholesky(K).contiguous()  # K11's input, the same in every tree
    del K, Lleaf
    torch.cuda.empty_cache()
    saved["K11 n=16384 bs=512"] = solve.diag_tri_inv(Lc, 512).cpu()
    print(f"{label} K11 n={n} bs=512 queued: {rounds({'K11': lambda: solve.diag_tri_inv(Lc, 512)}, 10, True)}",
          flush=True)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        torch.save(saved, os.path.join(outdir, f"{label}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
