#!/usr/bin/env python3
"""Where K14's launch spends its time: a copy of csrc/leaf.cu's leaf_inv with
%globaltimer stamps (ns) at the events of every work item.

    python3 chip_tools/k14_probe.py [--src a.cu,b.cu] [--bounds 2,1] [--wide 4,1] [--deep 8,16] [--s 1024]

Builds a copy of each --src (default gpr_tpu_torch/csrc/leaf.cu) with the
stamps added, for each value of --bounds (the CTAs an SM leaf_inv is compiled
for, __launch_bounds__' second argument), --wide and --deep (kInvWideFrom and
kInvDeepFrom: the levels, in 64-blocks, from which a piece sums 64 and 128
terms, and not 32), into a scratch directory with nvcc, prints the
compiler's registers and spills for leaf_inv, and runs K14 through ctypes on
the factor of chip_smoke.py phase 18's leaf (G G^T / s + I).  Prints K14's
time from CUDA events (queued behind a device sleep, median of 10) beside the
unstamped copy's, and, from one stamped launch (times in µs from the first
ticket drawn): per phase (the diagonal items, then T and X at each level h)
its items, when its first item was past its waits and its last output was
published, and the medians over its items of the draw (the ticket), the
decode, the wait, then for a diagonal item its load, its two 32-wide
inverses, its level of 32 and its store, for a piece its product, and the
publication of its partial and, for the last X piece of a tile, the sum and
W's tile; then the critical path, each phase's last publication after the phase
before's.
"""

import argparse
import ctypes
import itertools
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "gpr_tpu_torch" / "csrc"
# per ticket: 0 before the draw, 1 decoded, 2 past the waits, 3 product done,
# 4 partial published (X pieces), 5 done (W's tile written, or left, an X
# piece that was not last), 6 kind | hb << 4 | np << 12 | m << 16 | last << 20, 7 the CTA, 8 the
# ticket in the CTA's hands; a diagonal item's 9 block loaded, 10 its 32-wide
# inverses done, 11 its level done
SLOTS = 12
MAX_ITEMS = 4096


def variant(src: Path, bounds: str, wide: str, deep: str) -> str:
    """The source with leaf_inv's launch bounds, kInvWideFrom and kInvDeepFrom set."""
    s = src.read_text()
    for value, pattern, new in ((bounds, r"__launch_bounds__\(kInvThreads, \d+\)", f"__launch_bounds__(kInvThreads, {bounds})"),
                                (wide, r"constexpr int kInvWideFrom = \d+;", f"constexpr int kInvWideFrom = {wide};"),
                                (deep, r"constexpr int kInvDeepFrom = \d+;", f"constexpr int kInvDeepFrom = {deep};")):
        if value:
            s, k = re.subn(pattern, new, s)
            if k != 1:
                raise RuntimeError(f"{pattern} not found once")
    return s


def patched(s: str) -> str:
    s = s.replace("namespace gpr {\n", "namespace gpr {\n"
                  f"__device__ unsigned long long g_probe[{MAX_ITEMS * SLOTS}];\n"
                  "__device__ int g_item[1024];\n"
                  "__device__ __forceinline__ unsigned long long gtime() {\n"
                  "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
                  f"#define PROBE(k, v) if (threadIdx.x == 0) g_probe[item_sh * {SLOTS} + (k)] = (v)\n"
                  f"#define PROBE_D(k) if (threadIdx.x == 0) g_probe[g_item[blockIdx.x] * {SLOTS} + (k)] = gtime()\n",
                  1)
    last = "      PROBE(6, (unsigned long long)(it.kind | it.hb << 4 | it.np << 12 | it.m << 16 | 1 << 20));\n"
    edits = [  # (anchor, replacement)
        ("    if (threadIdx.x == 0) item_sh = atomicAdd(flags, 1);\n    __syncthreads();\n",
         "    unsigned long long pre_t = 0;\n"
         "    if (threadIdx.x == 0) pre_t = gtime(), item_sh = atomicAdd(flags, 1);\n    __syncthreads();\n"
         "    const unsigned long long held_t = gtime();\n"),
        ("    const InvItem it = inv_item(item_sh, pl);\n",
         "    const InvItem it = inv_item(item_sh, pl);\n    PROBE(0, pre_t);\n    PROBE(8, held_t);\n"
         "    PROBE(1, gtime());\n"
         "    PROBE(6, (unsigned long long)(it.kind | it.hb << 4 | it.np << 12 | it.m << 16));\n"
         "    PROBE(7, (unsigned long long)blockIdx.x);\n    if (threadIdx.x == 0) g_item[blockIdx.x] = item_sh;\n"),
        ("      inv_diag(L, ldl, W, ldw, it.q, ism);\n",
         "      PROBE(2, gtime());\n      inv_diag(L, ldl, W, ldw, it.q, ism);\n      PROBE(3, gtime());\n"),
        ("      inv_publish(&wready[it.q * (kInvMaxBlocks + 1)]);\n",
         "      inv_publish(&wready[it.q * (kInvMaxBlocks + 1)]);\n      PROBE(5, gtime());\n"),
        ("  __syncthreads();\n  if (warp < kInvBase / kInvNb) {\n",
         "  __syncthreads();\n  PROBE_D(9);\n  if (warp < kInvBase / kInvNb) {\n"),
        ("  __syncthreads();\n  // T = C inv(A) into Ts", "  __syncthreads();\n  PROBE_D(10);\n  // T = C inv(A) into Ts"),
        ("  for (int e = threadIdx.x; e < kInvBase * kInvBase; e += kInvThreads) {\n    const int rr",
         "  PROBE_D(11);\n  for (int e = threadIdx.x; e < kInvBase * kInvBase; e += kInvThreads) {\n    const int rr"),
        ("          }\n        }\n      __syncthreads();\n",
         "          }\n        }\n      __syncthreads();\n      PROBE(2, gtime());\n"),
        ("flag_wait(&tcount[(it.r0 + b) * kInvMaxBlocks + C], tp);\n      __syncthreads();\n",
         "flag_wait(&tcount[(it.r0 + b) * kInvMaxBlocks + C], tp);\n      __syncthreads();\n"
         "      PROBE(2, gtime());\n"),
        ("      inv_put_slot(slots + (size_t)it.m * kInvSlot, acc);\n",
         "      PROBE(3, gtime());\n      inv_put_slot(slots + (size_t)it.m * kInvSlot, acc);\n"),
        ("      inv_publish(&tcount[tile]);\n", "      inv_publish(&tcount[tile]);\n      PROBE(5, gtime());\n" + last),
        ("      const int mp = inv_mp(it.hb);\n", "      PROBE(3, gtime());\n      const int mp = inv_mp(it.hb);\n"),
        ("      inv_publish(&xcount[tile]);\n      if (!inv_last(&xdone[tile], it.np, &last_sh)) continue;\n",
         "      inv_publish(&xcount[tile]);\n      PROBE(4, gtime());\n"
         "      if (!inv_last(&xdone[tile], it.np, &last_sh)) {\n        PROBE(5, gtime());\n        continue;\n      }\n"),
        ("      inv_publish(&wready[tile]);\n", "      inv_publish(&wready[tile]);\n      PROBE(5, gtime());\n" + last),
    ]
    for anchor, new in edits:
        if s.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        s = s.replace(anchor, new)
    s += ('\nextern "C" int gpr_probe_read(unsigned long long* out) {\n'
          f'  return (int)cudaMemcpyFromSymbol(out, gpr::g_probe, sizeof(unsigned long long) * {MAX_ITEMS * SLOTS});\n'
          '}\n')
    return s


def build(nvcc: str, source: str, d: Path, name: str):
    cu = d / f"{name}.cu"
    cu.write_text(source)
    lib = d / f"{name}.so"
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-shared", "-Xptxas", "-v", f"-I{CSRC}", "-o", str(lib), str(cu)], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stderr}")
    lines = r.stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "leaf_inv" in line:
            info = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
            print(f"  {name}: leaf_inv {info}")
            break
    so = ctypes.CDLL(str(lib))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    so.gpr_tri_inv_leaf.argtypes = [P_, I_, P_, I_, P_, P_, I_, P_]
    so.gpr_tri_inv_leaf_scratch.argtypes = [I_, ctypes.POINTER(I_)]
    so.gpr_tri_inv_leaf_flags.argtypes = [ctypes.POINTER(I_)]
    if hasattr(so, "gpr_probe_read"):
        so.gpr_probe_read.argtypes = [P_]
    return so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(CSRC / "leaf.cu"))
    ap.add_argument("--bounds", default="")
    ap.add_argument("--wide", default="")
    ap.add_argument("--deep", default="")
    ap.add_argument("--s", type=int, default=1024)
    a = ap.parse_args()
    import torch

    dev = torch.device("cuda")
    s = a.s
    g = torch.Generator(device=dev).manual_seed(18)
    G = torch.randn((s, s), generator=g, device=dev)
    A = G @ G.T / s
    A.diagonal().add_(1.0)
    L = torch.linalg.cholesky(A).contiguous()
    eye = torch.eye(s, device=dev)
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    stream = torch.cuda.current_stream().cuda_stream
    print(f"K14 probe s={s} on {torch.cuda.get_device_name(0)}")
    for src, bounds, wide, deep in itertools.product(a.src.split(","), a.bounds.split(","), a.wide.split(","),
                                                     a.deep.split(",")):
        print(f"{Path(src).name} bounds={bounds or 'as is'} wide={wide or 'as is'} deep={deep or 'as is'}")
        plain = variant(Path(src), bounds, wide, deep)
        with tempfile.TemporaryDirectory() as d:
            libs = {"plain": build(nvcc, plain, Path(d), "plain"),
                    "stamped": build(nvcc, patched(plain), Path(d), "stamped")}
        out, ints = ctypes.c_int(0), ctypes.c_int(0)
        libs["plain"].gpr_tri_inv_leaf_scratch(s, ctypes.byref(out))
        libs["plain"].gpr_tri_inv_leaf_flags(ctypes.byref(ints))
        ws = torch.empty(out.value, device=dev)
        flags = torch.zeros(ints.value, dtype=torch.int32, device=dev)
        W = torch.empty_like(L)

        def call(so):
            rc = so.gpr_tri_inv_leaf(L.data_ptr(), s, W.data_ptr(), s, ws.data_ptr(), flags.data_ptr(), s,
                                     stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        for name, so in libs.items():
            call(so)
            torch.cuda.synchronize()
            res = float((W @ L - eye).abs().max())
            if not res < 1e-4 or bool(flags.any()):
                raise RuntimeError(f"{name}: |W L - I| = {res}, flags left {int(flags.count_nonzero())}")
            ms = []
            for _ in range(10):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(300_000)
                e0.record()
                call(so)
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            print(f"  {name}: {float(np.median(ms)):.4f} ms (queued; runs "
                  f"{', '.join(f'{x:.4f}' for x in ms)})")
        buf = np.zeros(MAX_ITEMS * SLOTS, np.uint64)
        libs["stamped"].gpr_probe_read(ctypes.c_void_p(buf.ctypes.data))
        report(buf.reshape(MAX_ITEMS, SLOTS))
    return 0


def report(p):
    items = p[p[:, 0] > 0]
    t0 = int(items[:, 0].min())
    us = lambda x: (x.astype(np.int64) - t0) / 1e3  # noqa: E731

    def span(a, b, rows=None):
        r = items if rows is None else rows
        return (r[:, b].astype(np.int64) - r[:, a].astype(np.int64)) / 1e3

    kind, hb = items[:, 6] & 0xF, (items[:, 6] >> 4) & 0xFF
    np_, last = (items[:, 6] >> 12) & 0xF, (items[:, 6] >> 20) & 1
    print(f"  {len(items)} items on {len(np.unique(items[:, 7]))} CTAs; kernel span "
          f"{us(items[:, 5]).max():.2f} µs from the first draw")
    prev_end, path = 0.0, []
    for k, h in sorted({(int(a), int(b)) for a, b in zip(kind, hb)}, key=lambda x: (x[1], x[0])):
        m = (kind == k) & (hb == h)
        it = items[m]
        name = "diagonal" if k == 0 else f"{'T' if k == 1 else 'X'} h={64 * h}"
        med = lambda v: f"{np.median(v):.2f}"  # noqa: E731
        text = (f"  {name}: {len(it)} items (np up to {int(np_[m].max())}); first past its waits "
                f"{us(it[:, 2]).min():.2f}, last published {us(it[:, 5]).max():.2f}; medians: draw "
                f"{med(span(0, 8, it))}, decode {med(span(8, 1, it))}, wait {med(span(1, 2, it))}, ")
        if k == 0:
            text += (f"load {med(span(2, 9, it))}, 32-wide inverses {med(span(9, 10, it))}, level "
                     f"{med(span(10, 11, it))}, store {med(span(11, 3, it))}, publication {med(span(3, 5, it))}")
        elif k == 1:
            text += f"product {med(span(2, 3, it))}, partial out {med(span(3, 5, it))}"
        else:
            lm = last[m].astype(bool)
            text += (f"product {med(span(2, 3, it))}, partial out {med(span(3, 4, it))}, last's sum and W "
                     f"{med(span(4, 5, it[lm]))}")
        print(text)
        end = us(it[:, 5]).max()
        path.append((name, end - prev_end))
        prev_end = end
    print("  critical path (µs a phase, its last publication after the phase before's): "
          + ", ".join(f"{n} {d:.2f}" for n, d in path))


if __name__ == "__main__":
    sys.exit(main())
