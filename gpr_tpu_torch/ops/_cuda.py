"""Build and load the port's hand-written CUDA kernels.

At first use, ``nvcc`` compiles every ``gpr_tpu_torch/csrc/*.cu`` into one
shared library with a plain C interface, ``gpr_tpu_torch/_build/
libgpr_kernels-<hash>.so``, keyed by a hash of the sources and flags, and
``ctypes`` loads it.  The sources compile in parallel, one ``nvcc`` process
each, and are then linked.  Nothing is built when a module is imported, and
there is no fallback: a missing ``nvcc`` or a failed build raises.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``; :class:`Kernel`
raises if that is not 0 and counts the launches that went through, as the
counter ``launch.<kernel>`` of utils/profiling.py, so that a run can show that
its path reached the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..utils.profiling import count, counters, reset_counters

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgpr_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's resource report (``-Xptxas -v``) is kept beside it as
    ``.ptxas.txt``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        # wait for every compiler before raising, so that none outlives the call
        report = "".join([p.communicate()[1] for p in procs])
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{report}")
        tmp = os.path.join(tmpdir, "lib.so")
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(report)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


_lib = None


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gpr_error_string.argtypes = [_I]
        lib.gpr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _call(name: str, symbol: str, argtypes, device: torch.device, args) -> None:
    """Call C entry point ``symbol`` with ``args`` and PyTorch's current
    stream on ``device``; raise on a non-zero return."""
    lib = library()
    fn = _bound.get((id(lib), symbol))
    if fn is None:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = _I
        _bound[(id(lib), symbol)] = fn
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.gpr_error_string(rc).decode()
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc} ({msg})")


_bound = {}


def query(symbol: str, device: torch.device, *ints: int) -> int:
    """Call ``symbol(int..., int* out)``, a C entry point that asks the
    runtime about a kernel's launch and launches nothing; raise on a
    non-zero return, else return ``out``."""
    lib = library()
    fn = getattr(lib, symbol)
    fn.argtypes = [_I] * len(ints) + [ctypes.POINTER(_I)]
    fn.restype = _I
    out = _I(-1)
    with torch.cuda.device(device):
        rc = fn(*ints, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({lib.gpr_error_string(rc).decode()})")
    return out.value


class Kernel:
    """One C entry point of the library and the count of its launches, with
    its provenance: ``source``, the file under ``csrc/`` that defines
    ``symbol``, and ``replaces``, the TPU kernel's ``def`` line in the JAX
    package (PERF.md section 6)."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.source = f"gpr_tpu_torch/csrc/{source}"
        self.replaces = f"gpr_tpu/ops/{replaces}"
        self.argtypes = list(argtypes) + [_P]  # the stream comes last
        self.counter = f"launch.{name}"

    def launch(self, device: torch.device, *args) -> None:
        _call(self.name, self.symbol, self.argtypes, device, args)
        count(self.counter)


class Schedule:
    """A C entry point that steps a sequence of the kernels above itself (a
    whole factorization), so that the host makes one call where it would
    make hundreds; the caller names how many launches of each kernel it
    made, and their counts grow by that."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [_P]  # the stream comes last

    def launch(self, device: torch.device, launches: dict, *args) -> None:
        _call(self.name, self.symbol, self.argtypes, device, args)
        for kernel, k in launches.items():
            count(kernel.counter, k)


# (X, Y, K, n, m, d, form, sigma, scale, third, diag, tril)
GRAM = Kernel("gram_tile", "gpr_gram", "gram.cu", "pallas_gram.py:38",
              [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I])
# (src, L, part, n_pad, n_true, d, j, blocks, form, sigma, scale, third, diag): three kernels
# in stream order (the products on `blocks` blocks, the last slice, the strip), one launch
PANEL_UPDATE = Kernel("panel_update", "gpr_panel_update", "fullchol.cu", "pallas_fullchol.py:722",
                      [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F])
# (L, W, n_pad, j)
DIAG_FACTOR_INV = Kernel("diag_factor_inv", "gpr_diag_factor_inv", "fullchol.cu",
                         "pallas_fullchol.py:722", [_P, _P, _I, _I])
# (L, W, n_pad, j)
PANEL_SOLVE = Kernel("panel_solve", "gpr_panel_solve", "fullchol.cu", "pallas_fullchol.py:722",
                     [_P, _P, _I, _I])
# (src, L, W, part0, part1, plan, n_pad, n_true, d, form, sigma, scale, third, diag, side): K2-K4
# over every panel with the one-panel lookahead
FACTOR_LOOKAHEAD = Schedule("factor_lookahead", "gpr_factor_lookahead",
                            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P])
# (A22, lda, Lp, ldp, out, ldo, m, k_pad): Lp the aligned, zero-filled copy of L21
SYRK_UPDATE = Kernel("syrk_update", "gpr_syrk_update", "syrk.cu", "pallas_syrk.py:73",
                     [_P, _I, _P, _I, _P, _I, _I, _I])

# (X, P, K, B, n, d, form)
GRAM_BATCHED = Kernel("gram_batched", "gpr_gram_batched", "gram.cu", "pallas_gram.py:142",
                      [_P, _P, _P, _I, _I, _I, _I])
# (A, a_batch_stride, a_ld, L, l_batch_stride, l_ld, B, b)
CROUT_CHOL = Kernel("crout_chol", "gpr_crout_chol", "crout.cu", "pallas_batched.py:205",
                    [_P, _LL, _I, _P, _LL, _I, _I, _I])
# (A, a_batch_stride, a_ld, L, l_batch_stride, l_ld, W, w_batch_stride, w_ld, B, b)
CROUT_CHOL_WI = Kernel("crout_chol_wi", "gpr_crout_chol_wi", "crout.cu", "pallas_batched.py:199",
                       [_P, _LL, _I, _P, _LL, _I, _P, _LL, _I, _I, _I])
# (A, L, Y, X, W, B, n, panel, q)
FLEET_FUSED = Kernel("fleet_fused", "gpr_fleet_fused", "fleet.cu", "pallas_batched.py:560",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I])
# (L, W, src, out, P, R, flags, n, q, bs, forward): one whole sweep, one persistent kernel
NARROW_SUBST = Kernel("narrow_subst", "gpr_narrow_subst", "solve.cu", "pallas_solve.py:52",
                      [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I])
# (L, ld, W, nb, bs)
DIAG_TRI_INV = Kernel("diag_tri_inv", "gpr_diag_tri_inv", "solve.cu", "pallas_solve.py:173",
                      [_P, _I, _P, _I, _I])

# (A, lda, L, ldl, WS, s): WS the published tiles' workspace; one cluster of s / 64 CTAs
LEAF_CHOL = Kernel("leaf_chol", "gpr_leaf_chol", "leaf.cu", "pallas_leaf.py:47",
                   [_P, _I, _P, _I, _P, _I])
# (A, lda, L, ldl, W, ldw, WS, flags, s): K12's cluster factor, then K14's launch on its L (WS
# both workspaces), one launch
LEAF_CHOL_WI = Kernel("leaf_chol_wi", "gpr_leaf_chol_wi", "leaf.cu", "pallas_leaf.py:118",
                      [_P, _I, _P, _I, _P, _I, _P, _P, _I])
# (L, ldl, W, ldw, WS, flags, s): one persistent kernel, items by ticket; flags zero at rest
TRI_INV_LEAF = Kernel("tri_inv_leaf", "gpr_tri_inv_leaf", "leaf.cu", "pallas_leaf.py:239",
                      [_P, _I, _P, _I, _P, _P, _I])

# (P, ldp, out, W, WS, n): two kernels in stream order (the diagonal tile on a cluster, the
# rows), one launch
PANEL_FACTOR = Kernel("panel_factor", "gpr_panel_factor", "panel.cu", "pallas_panel.py:143",
                      [_P, _I, _P, _P, _P, _I])
# (S, n, rows, cols, kcols, T, ks, bm, bk)
RANK_UPDATE_TILES = Kernel("rank_update_tiles", "gpr_rank_update_tiles", "inplace.cu",
                           "inplace_chol.py:53", [_P, _I, _P, _P, _P, _I, _I, _I, _I])
# (S, n, c0t, W, WS): K15's two kernels on the panel of S in place (the diagonal tile on a
# cluster, the rows), one launch
PANEL_INPLACE = Kernel("panel_inplace", "gpr_panel_inplace", "panel.cu", "inplace_chol.py:135",
                       [_P, _I, _I, _P, _P])
# (S, n, ti, tj, dg, T, bm)
ZERO_UPPER = Kernel("zero_upper", "gpr_zero_upper", "inplace.cu", "inplace_chol.py:201",
                    [_P, _I, _P, _P, _P, _I, _I])

# (A, L, W, n): W the panels' workspace
TILE_CHOL = Kernel("tile_chol", "gpr_tile_chol", "chol.cu", "pallas_chol.py:29", [_P, _P, _P, _I])
# (A, L, W, n, sw)
TILE_CHOL_STRIPS = Kernel("tile_chol_strips", "gpr_tile_chol_strips", "chol.cu", "pallas_chol.py:83",
                          [_P, _P, _P, _I, _I])

KERNELS = (GRAM, PANEL_UPDATE, DIAG_FACTOR_INV, PANEL_SOLVE, SYRK_UPDATE, GRAM_BATCHED, CROUT_CHOL,
           CROUT_CHOL_WI, FLEET_FUSED, NARROW_SUBST, DIAG_TRI_INV, LEAF_CHOL, LEAF_CHOL_WI,
           TRI_INV_LEAF, PANEL_FACTOR, RANK_UPDATE_TILES, PANEL_INPLACE, ZERO_UPPER, TILE_CHOL,
           TILE_CHOL_STRIPS)


def reset_launch_counts() -> None:
    reset_counters("launch.")


def launch_counts() -> dict:
    c = counters()
    return {k.name: c.get(k.counter, 0) for k in KERNELS}
