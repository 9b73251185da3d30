#!/usr/bin/env python3
"""Where K9's time goes: one launch of csrc/fleet.cu's fleet_fused_kernel,
each warp's lane 0 stamping clock64() at the phases of every panel step.

    python3 chip_tools/k9_probe.py [--src gpr_tpu_torch/csrc/fleet.cu] [--B 128] [--n 512] [--p 64] [--q 4]

Builds a copy of --src with the stamps added into a scratch directory with
nvcc (-I the source's directory, so that its headers resolve), runs it
through ctypes on the fleet's K (benchmarks/bench_batched.py's data,
Gaussian(2, 1), sigma 0.1) and prints, in cycles averaged over the members,
per panel step k: the panel solve (thread 0's own part), the update (from
there to the barrier after it: the strict upper's zeros, the wait for the
other warps' panel solve, the paired groups) and the CTA's diagonal step for
the next block; then the first diagonal step, the substitution, and thread
0's cycles in each part of a diagonal step (load, factor with W, stores),
averaged over the n / p steps.  The kernel's time from CUDA events (queued
behind a device sleep; median of 10) is printed beside the SM clock it
implies.  Cycles of different SMs are not compared.
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
SLOTS = 76  # per warp: 0 start, 2 first diagonal step, 3 end of the panels, 4 end; 8 + 4 k, 9 + 4 k,
# 10 + 4 k the phases of step k (k < 16); 72-74 thread 0's diagonal-step sums
EDITS = [
    ("  diag_step(Am, Lm, Wm, n, p, 0, f, smem, Xm, bs, ys, q);\n", "  probe(2);\n"),
    ("    __syncthreads();  // W_k in E; the trailing matrix written\n", "    probe(8 + 4 * k);\n"),
    ("slots + (G + warp) * tile, f.dc, vec, Xm, ys, q);\n", "    probe(9 + 4 * k);\n"),
    ("    __syncthreads();  // S22 written\n", "    probe(10 + 4 * k);\n"),
    ("    diag_step(Lm, Lm, Wm, n, p, k + 1, f, smem, Xm, bs, ys, q);\n  }\n  __syncthreads();\n", "  probe(3);\n"),
]


DIAG = ("  __syncthreads();\n  crout_factor<true>(smem, f.ld, f.bp / kCholNb, smem + f.rd);\n"
        "  crout_store(smem, f.ld, Lm + (size_t)k0 * n + k0, n, p);\n"
        "  crout_store_w(smem, f.ld, f.bp, Wm + (size_t)k * p * p, p, p);\n")


def patched(src: Path) -> str:
    s = src.read_text()
    if DIAG not in s:
        raise RuntimeError("anchor not found: diag_step's body")
    s = s.replace(DIAG, "  long long c0 = clock64();\n" + DIAG.replace(";\n", ";\n  probe_add(72, c0);\n", 1)
                  .replace("smem + f.rd);\n", "smem + f.rd);\n  probe_add(73, c0);\n")
                  + "  probe_add(74, c0);\n")
    s = s.replace("namespace gpr {\n", "namespace gpr {\n__device__ long long g_probe[256 * 8 * %d];\n"
                  "__device__ __forceinline__ void probe(int s) {\n"
                  "  if ((threadIdx.x & 31) == 0 && blockIdx.x < 256 && s < %d)\n"
                  "    g_probe[(blockIdx.x * 8 + (threadIdx.x >> 5)) * %d + s] = clock64();\n}\n"
                  "__device__ __forceinline__ void probe_add(int s, long long& c) {\n"
                  "  const long long now = clock64();\n"
                  "  if (threadIdx.x == 0 && blockIdx.x < 256) g_probe[blockIdx.x * 8 * %d + s] += now - c;\n"
                  "  c = now;\n}\n"
                  % (SLOTS, SLOTS, SLOTS, SLOTS), 1)
    s = s.replace("  const FusedLayout f = fused_layout(n, p);\n  const int t = threadIdx.x",
                  "  probe(0);\n  const FusedLayout f = fused_layout(n, p);\n  const int t = threadIdx.x", 1)
    for anchor, add in EDITS:
        if anchor not in s:
            raise RuntimeError(f"anchor not found: {anchor!r}")
        s = s.replace(anchor, anchor + add, 1)
    # the end of the substitution
    tail = "\n}\n\n}  // namespace gpr"
    i = s.rindex(tail)
    s = s[:i] + "\n  probe(4);" + s[i:]
    return s + ('\nextern "C" int gpr_probe_read(long long* out) {\n'
                '  return (int)cudaMemcpyFromSymbol(out, gpr::g_probe, sizeof(gpr::g_probe));\n}\n'
                'extern "C" int gpr_probe_write(const long long* in) {\n'
                '  return (int)cudaMemcpyToSymbol(gpr::g_probe, in, sizeof(gpr::g_probe));\n}\n')


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "gpr_tpu_torch" / "csrc" / "fleet.cu"))
    ap.add_argument("--B", type=int, default=128)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--p", type=int, default=64)
    ap.add_argument("--q", type=int, default=4)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from gpr_tpu_torch.ops import gram as gop

    src = Path(a.src).resolve()
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / "probe.cu"
        cu.write_text(patched(src))
        lib = Path(tmp) / "probe.so"
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
                            "-fPIC", "-shared", f"-I{src.parent}", "-Xptxas", "-v", str(cu), "-o", str(lib)],
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-4000:])
            return 1
        print("\n".join(line for line in r.stderr.splitlines() if "fleet_fused" in line or "Used" in line)[-600:])
        so = ctypes.CDLL(str(lib))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    so.gpr_fleet_fused.argtypes = [P_, P_, P_, P_, P_, I_, I_, I_, I_, P_]
    so.gpr_probe_read.argtypes = [P_]
    so.gpr_probe_write.argtypes = [P_]
    dev = torch.device("cuda")
    B, n, p, q = a.B, a.n, a.p, a.q
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((B, n, 8)), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.standard_normal((B, n, q)), dtype=torch.float32, device=dev)
    sig = float(np.float32(0.1))
    Pm = torch.tensor(np.tile([2.0, 1.0, 1.0, sig * sig], (B, 1)), dtype=torch.float32, device=dev)
    K = gop.gram_batched(X, Pm)
    L, Xo = torch.empty_like(K), torch.empty_like(Y)
    W = torch.empty((B, n // p, p, p), device=dev)

    def call():
        rc = so.gpr_fleet_fused(K.data_ptr(), L.data_ptr(), Y.data_ptr(), Xo.data_ptr(), W.data_ptr(), B, n, p, q,
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    times = []
    zero = np.zeros(256 * 8 * SLOTS, np.int64)
    for i in range(11):
        so.gpr_probe_write(ctypes.c_void_p(zero.ctypes.data))
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(300_000)
        e0.record()
        call()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    ms = float(np.median(times[1:]))
    buf = np.zeros(256 * 8 * SLOTS, np.int64)
    so.gpr_probe_read(ctypes.c_void_p(buf.ctypes.data))
    st = buf.reshape(256, 8, SLOTS)[:min(B, 256)].astype(np.float64)
    total = st[:, 0, 4] - st[:, 0, 0]
    print(f"K9 B={B} n={n} p={p} q={q}: {ms:.4f} ms (CUDA events, queued, median of 10); member 0..{st.shape[0] - 1}: "
          f"{total.mean():.0f} cycles from start to end (implied clock {total.mean() / ms / 1e3:.0f} MHz if one wave)")
    d = lambda a_, b_, w=0: float((st[:, w, b_] - st[:, w, a_]).mean())
    print(f"  first diagonal step {d(0, 2):.0f}")
    nb = n // p
    for k in range(nb - 1):
        s0 = 8 + 4 * k
        nxt = 8 + 4 * (k + 1) if k + 2 < nb else 3
        print(f"  step {k}: panel solve {d(s0, s0 + 1):.0f}; update {d(s0 + 1, s0 + 2):.0f}; "
              f"CTA diagonal step {d(s0 + 2, nxt):.0f}")
    print(f"  substitution {d(3, 4):.0f}")
    parts = st[:, 0, 72:75].mean(0) / nb
    print("  a diagonal step on warp 0, per step: " + ", ".join(
        f"{name} {v:.0f}" for name, v in zip(("load", "factor and W", "stores"), parts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
