"""ctypes bindings to the native runtime (native/gpr_native.cpp).

Provides threaded fast paths for the feature pipeline's I/O-bound image
loops, mirroring where the reference is native (reference
include/DataParser.h:536-613 image parsing).  Where the library has not
been built (``make -C native``) ``available()`` is False and the pipeline
reads with numpy.

Copied from gpr_tpu/utils/native.py (ctypes and numpy only): importing it
from ``gpr_tpu`` would run gpr_tpu/__init__.py, which imports JAX.  It loads
the same library, the repository root's ``native/libgpr_native.so``,
resolved from this file's own path as native.py:18-21 does.  Only what the
port's feature pipeline calls is copied: ``available``, ``load_vtk_dir`` and
``load_mha_dir`` (native.py:26-79 without the codec's signatures, 131-175;
pipeline/dataparser.py); the matrix codec, ``build`` and ``num_threads``
are not.
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

