"""Reference-compatible binary matrix serialization.

Copied from gpr_tpu/utils/matrixio.py:1-75 (numpy only): importing it from
``gpr_tpu`` would run gpr_tpu/__init__.py, which imports JAX.

Format (reference lib/MatrixIO.cpp:38-100): ASCII header ``"<rows> <cols>\n"``
followed by the raw row-major scalar dump.  The scalar type is implied by the
template instantiation in C++ (float32 or float64) and is therefore inferred
here from the payload size.  The test fixtures ``tests/data/breathing*.mat``
in the reference use float64.

This is the pure-numpy implementation, with the same bytes on disk as the
JAX package's native fast path.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def write_matrix(matrix, filename: str) -> None:
    """Write in the reference's MatrixIO format (lib/MatrixIO.cpp:77-100)."""
    m = np.asarray(matrix)
    if m.ndim == 1:
        m = m[:, None]  # Eigen vectors are n x 1
    if m.dtype not in (np.float32, np.float64):
        m = m.astype(np.float64)
    rows, cols = m.shape
    with open(filename, "wb") as f:
        f.write(f"{rows} {cols}\n".encode("ascii"))
        f.write(np.ascontiguousarray(m).tobytes())  # row-major


def read_matrix(filename: str, dtype=None) -> np.ndarray:
    """Read the reference's MatrixIO format (lib/MatrixIO.cpp:38-75).

    ``dtype`` may be given explicitly; otherwise it is inferred from the
    payload size (8 bytes/elem -> float64, 4 -> float32)."""
    with open(filename, "rb") as f:
        header = b""
        while True:
            c = f.read(1)
            if not c or c == b"\n":
                break
            header += c
        parts = header.split()
        if len(parts) < 2:
            raise ValueError(f"ReadMatrix: header is corrupt (filename {filename}).")
        rows, cols = int(parts[0]), int(parts[1])
        payload = f.read()
    n = rows * cols
    if dtype is None:
        if n == 0:
            dtype = np.float64
        elif len(payload) >= 8 * n:
            dtype = np.float64
        elif len(payload) >= 4 * n:
            dtype = np.float32
        else:
            raise ValueError(
                f"ReadMatrix: payload too small for {rows}x{cols} (filename {filename})."
            )
    dtype = np.dtype(dtype)
    data = np.frombuffer(payload[: n * dtype.itemsize], dtype=dtype)
    return data.reshape(rows, cols).copy()


def matrix_io_test(tmpdir: str | None = None) -> bool:
    """Self-test mirroring reference lib/MatrixIO.cpp:103-117."""
    path = os.path.join(tmpdir or tempfile.gettempdir(), "gpr_tpu_torch_matrixio_test.bin")
    M = np.random.default_rng(0).standard_normal((10, 3))
    write_matrix(M, path)
    N = read_matrix(path)
    os.remove(path)
    return M.shape == N.shape and bool(np.all(M == N))
