"""ctypes bindings to the native runtime (native/gpr_native.cpp).

Provides threaded fast paths for the feature pipeline's I/O-bound loops,
mirroring where the reference is native (reference
include/DataParser.h:536-613 image parsing, lib/MatrixIO.cpp codec).  Where
the library has not been built (``make -C native``, or :func:`build`)
``available()`` is False: the matrix codec falls back to numpy
(``utils/matrixio.py``) and the pipeline reads images with numpy.

Copied whole from gpr_tpu/utils/native.py (ctypes and numpy only):
importing it from ``gpr_tpu`` would run gpr_tpu/__init__.py, which imports
JAX.  It loads the same library, the repository root's
``native/libgpr_native.so``, resolved from this file's own path as
native.py:18-21 does.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libgpr_native.so",
)
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.gpr_matrix_shape.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.gpr_read_matrix.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.gpr_write_matrix.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        ctypes.c_long,
    ]
    lib.gpr_num_threads.argtypes = []
    for fn in (lib.gpr_matrix_shape, lib.gpr_read_matrix, lib.gpr_write_matrix, lib.gpr_num_threads,
               lib.gpr_probe_vtk, lib.gpr_load_vtk_dir, lib.gpr_probe_mha, lib.gpr_load_mha_dir):
        fn.restype = ctypes.c_int
    lib.gpr_probe_vtk.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.gpr_load_vtk_dir.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.float64, flags="F_CONTIGUOUS"),
    ]
    lib.gpr_probe_mha.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.gpr_load_mha_dir.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.float64, flags="F_CONTIGUOUS"),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build(verbose: bool = False) -> bool:
    """Compile the library in-tree with ``make -C native`` (needs g++;
    native.py:86-96)."""
    import subprocess

    r = subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)], capture_output=not verbose)
    global _lib
    _lib = None
    return r.returncode == 0 and available()


def read_matrix(path: str) -> np.ndarray:
    """MatrixIO read via the native codec, numpy's where the library is not
    built (native.py:99-119; reference lib/MatrixIO.cpp:38-75)."""
    lib = _load()
    if lib is None:
        from . import matrixio

        return matrixio.read_matrix(path)
    rows, cols = ctypes.c_long(), ctypes.c_long()
    rc = lib.gpr_matrix_shape(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"gpr_native: cannot read header of {path} (rc={rc})")
    n = rows.value * cols.value
    payload = os.path.getsize(path)
    # the scalar width from the payload size, as the numpy codec infers it
    with open(path, "rb") as f:
        header_len = len(f.readline())
    dtype_code = 0 if payload - header_len >= 8 * n else 1
    out = np.empty((rows.value, cols.value), np.float64)
    rc = lib.gpr_read_matrix(path.encode(), out, rows.value, cols.value, dtype_code)
    if rc != 0:
        raise IOError(f"gpr_native: read failed for {path} (rc={rc})")
    return out


def write_matrix(matrix, path: str) -> None:
    """MatrixIO write of ``matrix`` as float64 (native.py:122-130)."""
    lib = _load()
    m = np.ascontiguousarray(np.atleast_2d(np.asarray(matrix, np.float64)))
    if lib is None:
        from . import matrixio

        return matrixio.write_matrix(m, path)
    rc = lib.gpr_write_matrix(path.encode(), m, m.shape[0], m.shape[1])
    if rc != 0:
        raise IOError(f"gpr_native: write failed for {path} (rc={rc})")


def load_mha_dir(paths: Sequence[str], scale: float = 1.0) -> np.ndarray:
    """Threaded load of LOCAL-raw, uncompressed MetaImage frames into a
    column-major (features, frames) matrix — the .mha analogue of
    :func:`load_vtk_dir` (compressed/detached files raise; callers fall
    back to the Python codec)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("gpr_native library not built (run make -C native)")
    nvalues = ctypes.c_long()
    rc = lib.gpr_probe_mha(paths[0].encode(), ctypes.byref(nvalues))
    if rc != 0:
        raise IOError(f"gpr_native: cannot probe {paths[0]} (rc={rc})")
    nrows = nvalues.value
    joined = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.asfortranarray(np.empty((nrows, len(paths)), np.float64))
    rc = lib.gpr_load_mha_dir(joined, len(paths), nrows, scale, out)
    if rc != 0:
        raise IOError(f"gpr_native: mha directory load failed (rc={rc})")
    return out


def load_vtk_dir(paths: Sequence[str], scale: float = 1.0) -> np.ndarray:
    """Threaded load of identical-geometry binary VTK frames into a
    column-major (features, frames) matrix (the reference's
    ParseImageFiles/ParseDisplacementFiles loop, DataParser.h:536-613).

    Raises if the native library is unavailable — callers decide whether to
    fall back to the Python codec."""
    lib = _load()
    if lib is None:
        raise RuntimeError("gpr_native library not built (run make -C native)")
    npoints, ncomp = ctypes.c_long(), ctypes.c_long()
    rc = lib.gpr_probe_vtk(
        paths[0].encode(), ctypes.byref(npoints), ctypes.byref(ncomp)
    )
    if rc != 0:
        raise IOError(f"gpr_native: cannot probe {paths[0]} (rc={rc})")
    nrows = npoints.value * ncomp.value
    joined = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.asfortranarray(np.empty((nrows, len(paths)), np.float64))
    rc = lib.gpr_load_vtk_dir(joined, len(paths), nrows, scale, out)
    if rc != 0:
        raise IOError(f"gpr_native: directory load failed (rc={rc})")
    return out


def num_threads() -> int:
    """The library's OpenMP thread count, 1 without it (native.py:177-179)."""
    lib = _load()
    return int(lib.gpr_num_threads()) if lib else 1
