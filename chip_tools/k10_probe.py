#!/usr/bin/env python3
"""Where K10's sweep spends a block row: one forward and one backward sweep
of csrc/solve.cu's subst_sweep, with %globaltimer stamps (ns) at the events
of each block row's critical path.

    python3 chip_tools/k10_probe.py [--src a.cu,b.cu] [--ctas 1,3] [--n 16384] [--q 8]

Builds a copy of each --src (default gpr_tpu_torch/csrc/solve.cu) with the
stamps added (and kSubstCtas, the CTAs an SM it is compiled for, set to each
value of --ctas) into a scratch directory with nvcc, runs it through ctypes on
chip_smoke.py phase 14's system (the factor of X X^T / 64 + 4 I, bs = 512),
and prints, as medians over the block rows of each sweep (µs): the newest
partials' wait met after the block solved before (solved -> newest; negative
when they start before the whole block is in out), the last of them done
after that, the sum of the partials and r until the diagonal items' wait is
met (-> W start), the diagonal step (W), how long before that the older
partials' sum was ready, and a block row from solved to solved; with the
sweep's time from CUDA events (queued behind a device sleep; median of 5).
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
# per block row: 0 first newest partial past its wait (min), 1 last newest
# partial done (max), 2 the older partials' sum done (max), 3 first diagonal
# item past its wait (min), 4 last diagonal item done (max)
SLOTS = 5


def patched(src: Path, ctas: str) -> str:
    s = src.read_text()
    if ctas:
        s = re.sub(r"constexpr int kSubstCtas = \d+;", f"constexpr int kSubstCtas = {ctas};", s)
    s = s.replace("namespace gpr {\n", "namespace gpr {\n__device__ unsigned long long g_probe[4096 * 5];\n"
                  "__device__ __forceinline__ unsigned long long gtime() {\n"
                  "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n", 1)
    stamp = "      if (threadIdx.x == 0{}) atomic{}(&g_probe[i * 5 + {}], gtime());\n"
    edits = [  # (anchor, stamp, after the anchor)
        ("      __syncthreads();\n      fetch_rows<QC>(vr, out, q, col0, z * QC);\n",
         stamp.format(" && m >= nchunks - C", "Min", 0), True),
        ("      __syncthreads();\n      if (!last_sh) continue;\n", stamp.format(" && newest", "Max", 1), True),
        ("      if (threadIdx.x == 0) atomicAdd(newest ? &rdone[at] : &sdone[at], 1);\n",
         stamp.format(" && !newest", "Max", 2), False),
        ("      fetch_rows<QC>(vr, rhs, q, kc * kSubstChunk, z * QC);\n", stamp.format("", "Min", 3), False),
        ("      if (threadIdx.x == 0) atomicAdd(&solved[(i * G + g) * Z + z], 1);\n", stamp.format("", "Max", 4), False),
    ]
    for anchor, add, after in edits:
        if s.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        s = s.replace(anchor, anchor + add if after else add + anchor)
    s += ('\nextern "C" int gpr_probe_reset(int rows) {\n'
          '  static unsigned long long h[4096 * 5];\n'
          '  for (int r = 0; r < rows; ++r) for (int k = 0; k < 5; ++k) h[r * 5 + k] = (k == 0 || k == 3) ? ~0ull : 0ull;\n'
          '  return (int)cudaMemcpyToSymbol(gpr::g_probe, h, sizeof(unsigned long long) * rows * 5);\n}\n'
          'extern "C" int gpr_probe_read(unsigned long long* out, int rows) {\n'
          '  return (int)cudaMemcpyFromSymbol(out, gpr::g_probe, sizeof(unsigned long long) * rows * 5);\n}\n')
    return s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(CSRC / "solve.cu"))
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--q", type=int, default=8)
    ap.add_argument("--ctas", default="")
    a = ap.parse_args()
    import torch

    dev = torch.device("cuda")
    n, q, bs = a.n, a.q, 512
    nb = n // bs
    g = torch.Generator(device=dev).manual_seed(14)
    G = torch.randn((n, 64), generator=g, device=dev)
    A = G @ G.T / 64
    A.diagonal().add_(4.0)
    L = torch.linalg.cholesky(A).contiguous()
    del A, G
    eye = torch.eye(bs, device=dev)
    W = torch.linalg.solve_triangular(torch.stack([L[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs]
                                                   for i in range(nb)]), eye, upper=False).contiguous()
    B = torch.randn((n, q), generator=g, device=dev)
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    for src, ctas in [(x, c) for x in a.src.split(",") for c in a.ctas.split(",")]:
        with tempfile.TemporaryDirectory() as d:
            cu = Path(d) / "probe.cu"
            cu.write_text(patched(Path(src), ctas))
            lib = Path(d) / "probe.so"
            r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
                                "-fPIC", "-shared", f"-I{CSRC}", "-o", str(lib), str(cu)], capture_output=True, text=True)
            if r.returncode:
                print(r.stderr[-3000:])
                return 1
            so = ctypes.CDLL(str(lib))
            P_, I_ = ctypes.c_void_p, ctypes.c_int
            so.gpr_narrow_subst.argtypes = [P_] * 7 + [I_] * 4 + [P_]
            so.gpr_probe_read.argtypes = [P_, I_]
            stream = torch.cuda.current_stream().cuda_stream
            zq = -(-q // (8 if q <= 8 else 16))

            def sweep(src_, forward):
                out = torch.empty_like(src_)
                Pb = torch.empty((2 * max(nb - 1, 1) * bs + n) * (bs // 128) * q, device=dev)
                R = torch.empty_like(src_)
                flags = torch.zeros(6 * nb * (bs // 64) * zq + 1, dtype=torch.int32, device=dev)
                rc = so.gpr_narrow_subst(L.data_ptr(), W.data_ptr(), src_.data_ptr(), out.data_ptr(), Pb.data_ptr(),
                                         R.data_ptr(), flags.data_ptr(), n, q, bs, int(forward), stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
                return out

            for forward in (True, False):
                times = []
                for _ in range(6):
                    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(300_000)
                    ev[0].record()
                    sweep(B, forward)
                    ev[1].record()
                    ev[1].synchronize()
                    times.append(ev[0].elapsed_time(ev[1]))
                so.gpr_probe_reset(nb)
                sweep(B, forward)
                torch.cuda.synchronize()
                buf = np.zeros(nb * SLOTS, np.uint64)
                so.gpr_probe_read(ctypes.c_void_p(buf.ctypes.data), nb)
                t = buf.reshape(nb, SLOTS).astype(np.float64) / 1e3  # µs
                order = list(range(nb)) if forward else list(range(nb - 1, -1, -1))
                rows = {"solved -> newest": [], "-> last newest partial": [], "-> W start": [], "W": [],
                        "older sum ready before W start": [], "solved -> solved": []}
                for a_, b_ in zip(order[2:-1], order[3:]):  # rows with older partials and a row after them
                    rows["solved -> newest"].append(t[a_, 0] - t[order[order.index(a_) - 1], 4])
                    rows["-> last newest partial"].append(t[a_, 1] - t[a_, 0])
                    rows["-> W start"].append(t[a_, 3] - t[a_, 1])
                    rows["W"].append(t[a_, 4] - t[a_, 3])
                    rows["older sum ready before W start"].append(t[a_, 3] - t[a_, 2])
                    rows["solved -> solved"].append(t[b_, 4] - t[a_, 4])
                print(f"{Path(src).name} ctas={ctas or 'as built'} {'forward' if forward else 'backward'} n={n} q={q}: sweep "
                      f"{float(np.median(times[1:])):.4f} ms; per block row (µs, medians): " + "; ".join(
                          f"{k} {float(np.median(v)):.2f}" for k, v in rows.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
