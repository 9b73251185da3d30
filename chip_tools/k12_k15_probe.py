#!/usr/bin/env python3
"""Where K12's and K15's diagonal-kernel time goes: copies of csrc/leaf.cu
and csrc/panel.cu with thread 0 of each CTA stamping clock64() at the phases
of a call.

    python3 chip_tools/k12_k15_probe.py [--s 1024]

Builds each patched copy into a scratch directory with nvcc, runs it through
ctypes once to warm up, then ten times queued behind a device sleep (CUDA
events, median), and prints the cycles of each phase:
- K12 (leaf_chol_cluster) on a G G^T / s + I leaf, per diagonal step k, for
  the owner of block row k + 1: its wait at the cluster barrier for L_kk
  (from the end of its previous bulk), the staging of L_kk and L_k,k-1, the
  column's update, the rows' solve, the diagonal tile's update, the warp's
  factor of tile (k + 1, k + 1), its publication and the fence, then its bulk; and the
  most any CTA spent in its bulk;
- K15 (both kernels) on the first panel of an n = 8192 matrix G G^T / n + I:
  per CTA of the diagonal kernel (panel_diag_cluster) the factor (K19's),
  the inverse of its diagonal block, its block column of L_dd's store, W's
  block column (the step before the cluster barrier, the barrier and the
  steps after it), W's store; the rows kernel's block 0 loading its rows and
  walking W's chunks; then the time of K15 on panels of 4096, 2048 and 512
  rows.
Cycles of different SMs are not compared.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "gpr_tpu_torch" / "csrc"
PROBE = ("namespace gpr {\n__device__ long long g_probe[16 * 32 * 8];\n"
         "__device__ __forceinline__ void probe(int r, int k, int s) {\n"
         "  if (threadIdx.x == 0 && k >= 0) g_probe[(r * 32 + k) * 8 + s] = clock64();\n}\n")
READ = ('\nextern "C" int gpr_probe_read(long long* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, gpr::g_probe, sizeof(gpr::g_probe));\n}\n")


def patch(s: str, edits) -> str:
    s = s.replace("namespace gpr {\n", PROBE, 1)
    for anchor, add in edits:
        if s.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        s = s.replace(anchor, anchor + add)
    return s + READ


LEAF = [
    ("    cluster_wait();  // A_k: L_kk and panel k - 1 are in their slots\n", "    probe(rank, k, 0);\n"),
    ("      if (threadIdx.x < kCholNb) rd[threadIdx.x] = __ldcg(rds + k * kCholNb + threadIdx.x);\n"
     "      __syncthreads();\n", "      probe(rank, k, 1);\n"),
    ("Pk, kCholNb, lane, q);\n      __syncthreads();\n", "      probe(rank, k, 2);\n"),
    ("slot(k, i), kCholNb, lane);\n      __syncthreads();\n", "      probe(rank, k, 3);\n"),
    ("T, kLcLd, T, kLcLd, lane, q);\n      __syncthreads();\n", "      probe(rank, k, 4);\n"),
    ("written before its arrive\n      __syncthreads();\n", "      probe(rank, k, 5);\n"),
    ("    if (k > 0) leaf_bulk(own, ring, WS, nt, r0, r1, k);\n", "    probe(rank, k, 6);\n"),
]
PANEL = [
    ("  extern __shared__ __align__(16) float smem[];\n  int own[2], no;\n", "  probe(cluster_rank(), 0, 0);\n"),
    ("  tile_chol_factor<1>(P, ldp, WS, kPanel, smem, own, &no);\n", "  probe(cluster_rank(), 0, 1);\n"),
    ("    __threadfence();  // V_b is published before this thread's arrive\n  }\n  __syncthreads();\n",
     "  probe(cluster_rank(), 0, 2);\n"),
    ("  store_column(out, kPanel, kPanel, b, kPanelBlocks, Lb);\n  __syncthreads();", "\n  probe(cluster_rank(), 0, 3);"),
    ("read before they are written again\n    }\n  }\n", "  probe(cluster_rank(), 0, 4);\n"),
    ("  __syncthreads();  // W_7b is written\n", "  probe(cluster_rank(), 0, 5);\n"),
    ("  const size_t r0 = kPanel + (size_t)blockIdx.x * kPanelRowTile;\n", "  if (blockIdx.x == 0) probe(8, 0, 0);\n"),
    ("    for (int u = 0; u < kPanelRowTile; ++u) sA[c * kRowALd + u] = v[u];\n  }\n",
     "  if (blockIdx.x == 0) probe(8, 0, 1);\n"),
    ("\n  cp_async_wait<0>();\n", "  if (blockIdx.x == 0) probe(8, 0, 2);\n"),
    # per step: the rows kernel's chunk g (block 0), W's block row m (CTA 0)
    ("    row_stage(Wt, sW, g + 2);\n", "    if (blockIdx.x == 0) probe(9, g, 0);\n"),
    ("    __syncthreads();  // chunk g (and the rows) are in shared memory for every thread\n",
     "    if (blockIdx.x == 0) probe(9, g, 1);\n"),
    ("    __syncthreads();  // the slot is read before chunk g + 3 refills it\n", "    if (blockIdx.x == 0) probe(9, g, 2);\n"),
    ("      if (m == kLast) break;\n", "      if (cluster_rank() == 0) probe(10, m, 1);\n"),
    ("__syncthreads();  // panel m is staged and W_mb written, for every thread\n",
     "      if (cluster_rank() == 0) probe(10, m, 2);\n"),
    ("Wc + m * kCholNb * kCholNb, lane);\n", "      if (cluster_rank() == 0) probe(10, m, 3);\n"),
    ("read before they are written again\n", "      if (cluster_rank() == 0) probe(10, m, 4);\n"),
    ("if (m > b) {  // W_mb = -V_m T_m, thread t a row t / 8 and columns 4 (t % 8) .. + 3\n",
     "        if (cluster_rank() == 0) probe(10, m, 0);\n"),
]


def build(name: str, text: str, d: Path):
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    src, lib = d / f"{name}.cu", d / f"lib{name}.so"
    src.write_text(text)
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        f"-I{CSRC}", "-shared", "-o", str(lib), str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr)
    so = ctypes.CDLL(str(lib))
    so.gpr_probe_read.argtypes = [ctypes.c_void_p]
    return so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--s", type=int, default=1024)
    args = ap.parse_args()
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    P_, I_ = ctypes.c_void_p, ctypes.c_int

    def spd(n):
        G = torch.randn((n, n), generator=g, device=dev)
        A = G @ G.T / n
        A.diagonal().add_(1.0)
        return A

    def run(call, so):
        call()
        torch.cuda.synchronize()
        ms = []
        for _ in range(10):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(300_000)
            a.record()
            call()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        buf = np.zeros(16 * 32 * 8, np.int64)
        so.gpr_probe_read(ctypes.c_void_p(buf.ctypes.data))
        torch.cuda.synchronize()
        return float(np.median(ms)), buf.reshape(16, 32, 8)

    with tempfile.TemporaryDirectory() as d:
        leaf = build("leaf_probe", patch((CSRC / "leaf.cu").read_text(), LEAF), Path(d))
        panel = build("panel_probe", patch((CSRC / "panel.cu").read_text(), PANEL), Path(d))
    leaf.gpr_leaf_chol.argtypes = [P_, I_, P_, I_, P_, I_, P_]
    panel.gpr_panel_factor.argtypes = [P_, I_, P_, P_, P_, I_, P_]

    s = args.s
    nt = s // 32
    A = spd(s)
    L = torch.empty_like(A)
    ws = torch.empty(nt * (nt * 1024 + 32), device=dev)

    def leaf_call():
        if leaf.gpr_leaf_chol(A.data_ptr(), s, L.data_ptr(), s, ws.data_ptr(), s,
                              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("K12 launch failed")

    ms, pr = run(leaf_call, leaf)
    err = float((L.double() @ L.double().T - A.double()).norm() / A.double().norm())
    print(f"K12 s={s}: {ms:.4f} ms, recon {err:.3g}")
    names = ("wait", "stage", "column update", "solve", "diagonal update", "factor", "bulk")
    tot = np.zeros(len(names) + 1)
    for k in range(nt - 1):
        o = k + 1 if k + 1 < nt // 2 else nt - 2 - k  # the CTA that holds block row k + 1
        c = pr[o, k]
        prev = pr[o, k - 1, 6] if k > 0 else 0
        seg = [c[0] - prev if prev else 0] + [c[i] - c[i - 1] for i in range(1, 7)]
        bulk = max(int(pr[r, k, 6] - pr[r, k, 5]) for r in range(nt // 2) if pr[r, k, 5])
        tot += seg + [bulk]
        print(f"  k={k:2d} owner {o:2d}: " + ", ".join(f"{nm} {v}" for nm, v in zip(names, seg))
              + f"; most bulk {bulk}")
    print("  sums (cycles): " + ", ".join(f"{nm} {int(v)}" for nm, v in zip(names + ("most bulk",), tot)))

    n = 8192
    A = spd(n)
    P = A[:, :256]
    out = torch.empty((n, 256), device=dev)
    W = torch.empty((256, 256), device=dev)
    ws = torch.empty(7 * 32 * 480 + 8 * 1024, device=dev)

    def panel_call():
        if panel.gpr_panel_factor(P.data_ptr(), n, out.data_ptr(), W.data_ptr(), ws.data_ptr(), n,
                                  torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("K15 launch failed")

    ms, pr = run(panel_call, panel)
    print(f"K15 (8192, 256), both kernels: {ms:.4f} ms")
    names = ("factor", "inverse", "L_dd's store", "W's steps", "W's store")
    for r in range(8):
        c = pr[r, 0]
        print(f"  CTA {r}: " + ", ".join(f"{nm} {int(c[i + 1] - c[i])}" for i, nm in enumerate(names)))
    c = pr[8, 0]
    print(f"  rows kernel, block 0: its rows loaded {int(c[1] - c[0])}, W's chunks {int(c[2] - c[1])}")
    print("  rows kernel, block 0, chunk g: wait, compute: " + "; ".join(
        f"{g}: {int(pr[9, g, 1] - pr[9, g, 0])}, {int(pr[9, g, 2] - pr[9, g, 1])}" for g in range(10)))
    print("  CTA 0, W's block row m: W_m0, stage wait, product, rest (the barrier at m = 0): " + "; ".join(
        f"{m}: {int(pr[10, m, 1] - pr[10, m, 0]) if m else 0}, {int(pr[10, m, 2] - pr[10, m, 1])}, "
        f"{int(pr[10, m, 3] - pr[10, m, 2])}, {int(pr[10, m, 4] - pr[10, m, 3])}" for m in range(7)))
    for m in (4096, 2048, 512):  # a smaller panel: fewer row blocks
        P = A[:m, :256]

        def small_call():
            if panel.gpr_panel_factor(P.data_ptr(), n, out.data_ptr(), W.data_ptr(), ws.data_ptr(), m,
                                      torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("K15 launch failed")

        print(f"K15 ({m}, 256), both kernels: {run(small_call, panel)[0]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
