#!/usr/bin/env python3
"""Where K1's tensor-core path spends its time: one launch of csrc/gram.cu's
gram_tc_kernel with lane 0 of each warpgroup of block 0 stamping clock64()
at the phases of every k-slice; and the card's write rate for K1's and K6's
output bytes.

    python3 chip_tools/k1_probe.py [--src gpr_tpu_torch/csrc/gram.cu] [--n 16384] [--d 128]

Builds a copy of --src with the stamps added into a scratch directory with
nvcc (-I the source's directory, so that its headers resolve), runs gpr_gram
through ctypes on the bench data (Gaussian(8, 1), d = 128, the lower
triangle) and prints, in cycles averaged over block 0's slices 8-59 (the
first tiles' warm-up left out), per warpgroup, apart for the slices that
write the last tile and those that do not: issuing the wgmma groups with
the next slice's split between them (a wgmma waits for room while the
tensor cores are busy), the loads of the slice after it, the last tile's
epilogue, the wait for the products, the fold into the running tile and the
barrier; then the slice totals, tile by tile.  The
patched kernel's time (CUDA events, queued behind a device sleep; median of
6) is printed beside that of the unpatched library the package builds, and
torch.Tensor.fill_ of the same output bytes (K1's lower triangle, K6's
(B, n, n) at B=128, n=512 and B=256, n=1024) gives the card's write rate.
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
SLOTS = 7  # per slice: 0 top, 1 after the wgmma groups are issued (the next slice split between them),
# 2 after the loads of the slice after it, 3 after the last tile's epilogue, 4 after the wait, 5 after the fold,
# 6 after the barrier
EDITS = [
    ("    fence_operands(part);\n    wgmma_fence();\n", "probe(0);\n", True),
    ("    wgmma_commit();\n", "    probe(1);\n", False),
    ("    if (s + 2 < S) load();\n", "    probe(2);\n", False),
    ("      ready = false;\n    }\n", "    probe(3);\n", False),
    ("    wgmma_wait_all();\n    fence_operands(part);\n", "    probe(4);\n", False),
    ("    if (last) {\n      ready = true;\n", "probe(5);\n", True),
    ("    __syncthreads();  // slice s + 1 split, the norms written, slice s's tiles free, for all\n",
     "    probe(6);\n", False),
]


def patched(src: Path) -> str:
    s = src.read_text()
    for anchor, add, before in EDITS:
        if anchor not in s:
            raise RuntimeError(f"anchor not found: {anchor!r}")
        s = s.replace(anchor, ("    " + add + anchor) if before else (anchor + add), 1)
    # the stamp itself, inside the kernel where s is the slice index
    s = s.replace("probe(", "GT_PROBE(")
    s = s.replace("template <int FORM>\n__global__ void __launch_bounds__(kTcThreads, 1)",
                  f"__device__ long long g_probe[2 * 64 * {SLOTS}];\n"
                  "#define GT_PROBE(k) if (blockIdx.x == 0 && threadIdx.x % 128 == 0 && s < 64) "
                  f"g_probe[((threadIdx.x / 128) * 64 + s) * {SLOTS} + (k)] = clock64();\n"
                  "template <int FORM>\n__global__ void __launch_bounds__(kTcThreads, 1)", 1)
    return s + ('\nextern "C" int gpr_probe_read(long long* out) {\n'
                '  return (int)cudaMemcpyFromSymbol(out, gpr::g_probe, sizeof(gpr::g_probe));\n}\n')


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "gpr_tpu_torch" / "csrc" / "gram.cu"))
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--d", type=int, default=128)
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
        so = ctypes.CDLL(str(lib))
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.gpr_gram.argtypes = [P_, P_, P_, I_, I_, I_, I_, F_, F_, F_, F_, I_, P_]
    so.gpr_probe_read.argtypes = [P_]
    dev = torch.device("cuda")
    n, d = a.n, a.d
    X = torch.tensor(np.random.default_rng(0).standard_normal((n, d)), dtype=torch.float32, device=dev)
    K = torch.empty((n, n), dtype=torch.float32, device=dev)
    diag = float(np.float32(0.1)) ** 2

    def patched_call():
        rc = so.gpr_gram(X.data_ptr(), X.data_ptr(), K.data_ptr(), n, n, d, 0, 8.0, 1.0, 1.0, diag, 1,
                         torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    def queued(fn, reps=6):
        t = []
        for _ in range(reps + 1):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(300_000)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            t.append(e0.elapsed_time(e1))
        return float(np.median(t[1:]))

    ms_probe = queued(patched_call)
    ms = queued(lambda: gop.gram(X, X, 8.0, 1.0, 1.0, diag, tril=True))
    buf = np.zeros(2 * 64 * SLOTS, np.int64)
    so.gpr_probe_read(ctypes.c_void_p(buf.ctypes.data))
    st = buf.reshape(2, 64, SLOTS).astype(np.float64)
    nk = (d + 31) // 32
    print(f"K1 n={n} d={d} tril gaussian: {ms:.4f} ms (the package's library), {ms_probe:.4f} with the stamps "
          f"(CUDA events, queued, median of 6); block 0, slices 8-59, cycles:")
    for wg in range(2):
        s = st[wg, 8:60]
        seg = np.diff(s, axis=1)
        ep = np.array([(i + 8) % nk == 0 for i in range(len(s))])  # the slices that write the last tile
        tot = st[wg, 9:61, 0] - st[wg, 8:60, 0]
        names = ("wgmma groups issued with the next slice split", "loads of the one after", "epilogue", "wait",
                 "fold", "barrier")
        parts = [f"{nm} {seg[~ep, i].mean():.0f} / {seg[ep, i].mean():.0f}" for i, nm in enumerate(names)]
        print(f"  warpgroup {wg} (a slice without / with the last tile's epilogue): " + "; ".join(parts)
              + f"; slice {tot[~ep].mean():.0f} / {tot[ep].mean():.0f}")
        print(f"    slice totals {tot[:16].astype(int).tolist()}")
    low = n * (n + 1) // 2
    for label, numel in ((f"K1's lower triangle at n={n}", low), ("K6 at B=128, n=512", 128 * 512 * 512),
                         ("K6 at B=256, n=1024", 256 * 1024 * 1024)):
        out = torch.empty(numel, dtype=torch.float32, device=dev)
        t = queued(lambda: out.fill_(1.0), 10)
        print(f"fill_ of {label} ({numel * 4 / 1e9:.3f} GB): {t:.4f} ms = {numel * 4 / t / 1e9:.2f} TB/s")
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
