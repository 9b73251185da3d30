#!/usr/bin/env python3
"""Where K19's time goes: one call of csrc/chol.cu's tile_chol_kernel, with
each CTA's thread 0 stamping clock64() at the phases of every diagonal step.

    python3 chip_tools/k19_probe.py [--src a.cu,b.cu] [--threads 256,512] [--n 512] [--sw 1]

Builds a copy of each --src (default gpr_tpu_torch/csrc/chol.cu, e.g. an
older version beside it) with the stamps added (and kCholThreads set to each
value of --threads) into a scratch directory with nvcc, runs it through
ctypes on the tile of chip_smoke.py phase 25, and prints per step k the
owner of block column k + 1's cycles in each phase (waiting at the cluster
barrier for panel k, copying it from the workspace, updating and factoring
the diagonal block on warp 0, waiting for the other warps' update of the
blocks below, the rows' solve, publishing the panel, its other column's
update) and the most any other CTA spent updating, with the kernel's time from CUDA events (queued behind a
device sleep; median of 10).  Cycles of different SMs are not compared.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "gpr_tpu_torch" / "csrc"
SLOTS = ("wait", "copy", "diag", "below", "solve", "fence", "other update", "others' update")


def patched(src: Path, threads: int) -> str:
    s = src.read_text()
    header = src.parent / "chol.cuh"  # where chol.cu's device code lives
    if '#include "chol.cuh"' in s and header.exists():
        s = s.replace('#include "chol.cuh"', header.read_text().replace("#pragma once", ""))
    s = re.sub(r"constexpr int kCholThreads = \d+;", f"constexpr int kCholThreads = {threads};", s)
    s = s.replace("namespace gpr {\n", "namespace gpr {\n__device__ long long g_probe[8 * 16 * 8];\n"
                  "__device__ __forceinline__ void probe(int r, int k, int s) {\n"
                  "  if (threadIdx.x == 0 && k >= 0) g_probe[(r * 16 + k) * 8 + s] = clock64();\n}\n", 1)
    edits = [
        ("    cluster_wait();  // panel k is in its slot\n", "    probe(rank, k, 0);\n"),
        ("    copy_panel(W, PT, k, cols[0], nt);\n    __syncthreads();\n", "    probe(rank, k, 1);\n"),
        ("    diag_factor<SW>(P, ld, rd, lane);\n", "    probe(cluster_rank(), j - 1, 2);\n"),
        ("  __syncthreads();\n  float* Wj", None),
        ("row_solve<SW>(P, ld, r, P, ld, rd, Wj, kCholLdp, r - kCholNb);\n", "  probe(cluster_rank(), j - 1, 3);\n"),
        ("      factor_column<SW>(smem, PT, rd, W, k + 1, nt);\n", "      probe(rank, k, 4);\n"),
        ("      update_columns(smem, PT, cols + 1, nc - 1, k, nt);\n", "      __syncthreads();\n      probe(rank, k, 5);\n"),
        ("      update_columns(smem, PT, cols, nc, k, nt);\n", "      __syncthreads();\n      probe(rank, k, 6);\n"),
    ]
    for anchor, add in edits:
        if anchor not in s:
            raise RuntimeError(f"anchor not found: {anchor!r}")
        if add is None:  # the barrier after the diagonal block and the blocks below it
            s = s.replace(anchor, anchor.replace("  float* Wj", "  probe(cluster_rank(), j - 1, 7);\n  float* Wj"))
        else:
            s = s.replace(anchor, anchor + add)
    return s + ('\nextern "C" int gpr_probe_read(long long* dst) {\n'
                "  return (int)cudaMemcpyFromSymbol(dst, gpr::g_probe, sizeof(gpr::g_probe));\n}\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(CSRC / "chol.cu"))
    ap.add_argument("--threads", default="256")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--sw", type=int, default=1)
    args = ap.parse_args()
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    n = args.n
    G = torch.randn((n, n), generator=g, device=dev)
    A = G @ G.T / n
    A.diagonal().add_(1.0)
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    variants = [(Path(p), int(t)) for p in args.src.split(",") for t in args.threads.split(",")]
    for path, threads in variants:
        with tempfile.TemporaryDirectory() as d:
            src = Path(d) / "chol_probe.cu"
            src.write_text(patched(path, threads))
            lib = Path(d) / "libprobe.so"
            r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
                                "-fPIC", "-Xptxas", "-v", f"-I{CSRC}", "-shared", "-o", str(lib), str(src)],
                               capture_output=True, text=True)
            if r.returncode:
                print(r.stderr)
                return 1
            regs = re.findall(r"Used (\d+) registers", r.stderr)
            spills = re.findall(r"(\d+) bytes spill stores", r.stderr)
            so = ctypes.CDLL(str(lib))
        P, I = ctypes.c_void_p, ctypes.c_int
        so.gpr_tile_chol.argtypes = [P, P, P, I, P]
        so.gpr_tile_chol_strips.argtypes = [P, P, P, I, I, P]
        so.gpr_probe_read.argtypes = [P]
        L = torch.empty_like(A)
        W = torch.empty(max((n + 31) // 32 - 1, 1) * 32 * 480, device=dev)

        def call():
            st = torch.cuda.current_stream().cuda_stream
            rc = (so.gpr_tile_chol(A.data_ptr(), L.data_ptr(), W.data_ptr(), n, st) if args.sw == 1
                  else so.gpr_tile_chol_strips(A.data_ptr(), L.data_ptr(), W.data_ptr(), n, args.sw, st))
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

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
        buf = np.zeros(8 * 16 * 8, np.int64)
        so.gpr_probe_read(ctypes.c_void_p(buf.ctypes.data))
        torch.cuda.synchronize()
        pr = buf.reshape(8, 16, 8)
        L64 = L.double()
        rec = float(torch.linalg.norm(L64 @ L64.T - A.double()) / torch.linalg.norm(A.double()))
        print(f"{path.name} threads={threads} n={n} sw={args.sw}: registers {regs}, spill stores {spills}; "
              f"{float(np.median(ms)):.4f} ms (runs {', '.join(f'{t:.4f}' for t in ms)}); recon {rec:.3g}")
        nt = (n + 31) // 32
        tot = np.zeros(len(SLOTS))
        for k in range(nt - 1):
            o = k + 1 if k + 1 < 8 else 14 - k
            c = pr[o, k]
            prev = pr[o, k - 1, 5] if k > 0 and pr[o, k - 1, 5] else (pr[o, k - 1, 6] if k > 0 else 0)
            seg = [c[0] - prev if prev else 0, c[1] - c[0], c[2] - c[1], c[7] - c[2], c[3] - c[7], c[4] - c[3],
                   c[5] - c[4] if c[5] else 0]
            others = [pr[r, k, 6] - pr[r, k, 1] for r in range(8) if r != o and pr[r, k, 6] and pr[r, k, 1]]
            seg.append(max(others) if others else 0)
            tot += seg
            print(f"  k={k:2d} owner {o}: " + ", ".join(f"{nm} {v}" for nm, v in zip(SLOTS, seg)))
        print("  sums (cycles): " + ", ".join(f"{nm} {int(v)}" for nm, v in zip(SLOTS, tot)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
