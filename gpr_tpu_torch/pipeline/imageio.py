"""ITK-free medical-image I/O: legacy VTK structured points, MetaImage, PNG.

Copied from gpr_tpu/pipeline/imageio.py:1-369 (numpy only; PIL imported
lazily for PNG): importing it from ``gpr_tpu`` would run gpr_tpu/__init__.py,
which imports JAX.  The files it writes are byte for byte the JAX package's.

The reference links the full ITK toolkit for image I/O (reference
include/itkUtils.h:750-846 ReadImage/WriteImage; DVF series written as
legacy ``.vtk`` files, apps/GaussianProcessPredict.cpp:55-94).  This module
implements the three formats the GPR pipeline actually touches as pure
numpy codecs:

  * legacy VTK STRUCTURED_POINTS (ASCII + binary big-endian), scalar and
    N-component vector point data — the DVF and basis/mean artifact format;
  * MetaImage ``.mha``/``.mhd`` (local or detached raw, optional zlib
    compression) — the volume format of the 4D-MRI pipeline;
  * PNG (via PIL) — 2-D ultrasound navigator frames.

Array convention: ``data`` is indexed [z, y, x] (or [y, x] in 2-D) with an
optional trailing component axis — C-order flattening then matches ITK's
iteration order (x fastest), which is what the reference's matrix
flattening relies on (reference include/DataParser.h:536-613).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Image:
    """A geometric image: voxel array + physical metadata.

    data          [z, y, x(, c)] (or [y, x(, c)] in 2-D)
    spacing       (sx, sy, sz) — x-first, like ITK
    origin        (ox, oy, oz)
    ncomponents   trailing component axis size (1 for scalar images)
    """

    data: np.ndarray
    spacing: Tuple[float, ...]
    origin: Tuple[float, ...]
    ncomponents: int = 1

    @property
    def size(self) -> Tuple[int, ...]:
        """(sx, sy, sz) — x-first, like ITK's LargestPossibleRegion."""
        shape = self.data.shape[: -1] if self.ncomponents > 1 else self.data.shape
        return tuple(reversed(shape))

    def flatten(self) -> np.ndarray:
        """ITK-iteration-order flattening: x fastest, components innermost
        (the order the reference's ParseImageFiles/ParseDisplacementFiles
        produce, DataParser.h:536-613)."""
        return np.ascontiguousarray(self.data).reshape(-1)

    def like(self, flat: np.ndarray, ncomponents: Optional[int] = None) -> "Image":
        """New image with this image's geometry and the given flat data."""
        nc = self.ncomponents if ncomponents is None else ncomponents
        shape = self.data.shape[: -1] if self.ncomponents > 1 else self.data.shape
        if nc > 1:
            data = np.asarray(flat).reshape(*shape, nc)
        else:
            data = np.asarray(flat).reshape(shape)
        return Image(data=data, spacing=self.spacing, origin=self.origin, ncomponents=nc)


# ---------------------------------------------------------------------------
# legacy VTK structured points
# ---------------------------------------------------------------------------

_VTK_TO_NP = {
    "float": ">f4",
    "double": ">f8",
    "int": ">i4",
    "short": ">i2",
    "unsigned_short": ">u2",
    "unsigned_char": ">u1",
    "char": ">i1",
    "unsigned_int": ">u4",
    "long": ">i8",
    "unsigned_long": ">u8",
}
_NP_TO_VTK = {
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
    np.dtype(np.int32): "int",
    np.dtype(np.int16): "short",
    np.dtype(np.uint16): "unsigned_short",
    np.dtype(np.uint8): "unsigned_char",
}


def read_vtk(path: str) -> Image:
    """Read a legacy VTK STRUCTURED_POINTS file (ASCII or binary).

    Binary payloads are big-endian per the VTK legacy spec (what ITK's
    VTKImageIO writes for the reference's DVFs)."""
    with open(path, "rb") as f:
        raw = f.read()

    # header is ASCII lines up to (and including) the POINT_DATA section
    # attribute declaration; find it incrementally
    pos = 0

    def next_line():
        nonlocal pos
        end = raw.index(b"\n", pos)
        line = raw[pos:end].decode("ascii", "replace").strip()
        pos = end + 1
        return line

    next_line()  # "# vtk DataFile Version x.x"
    next_line()  # title
    fmt = next_line().upper()  # ASCII | BINARY
    dataset = next_line().split()
    if len(dataset) != 2 or dataset[1].upper() != "STRUCTURED_POINTS":
        raise ValueError(f"ReadImage: {path} is not a STRUCTURED_POINTS vtk file")

    dims = spacing = origin = None
    npoints = None
    kind = None  # "SCALARS" | "VECTORS"
    dtype = None
    ncomp = 1
    while True:
        line = next_line()
        if not line:
            continue
        tok = line.split()
        key = tok[0].upper()
        if key == "DIMENSIONS":
            dims = tuple(int(v) for v in tok[1:4])
        elif key in ("SPACING", "ASPECT_RATIO"):
            spacing = tuple(float(v) for v in tok[1:4])
        elif key == "ORIGIN":
            origin = tuple(float(v) for v in tok[1:4])
        elif key == "POINT_DATA":
            npoints = int(tok[1])
        elif key == "SCALARS":
            kind = "SCALARS"
            dtype = _VTK_TO_NP[tok[2]]
            ncomp = int(tok[3]) if len(tok) > 3 else 1
            # some writers omit LOOKUP_TABLE: remember the RAW byte offset
            # and rewind to it (the decoded/stripped line length miscounts
            # for CRLF endings, padded lines, or binary payload bytes)
            mark = pos
            try:
                lookup = next_line()
            except ValueError:  # binary payload without any newline byte
                lookup = ""
            if not lookup.upper().startswith("LOOKUP_TABLE"):
                pos = mark
            break
        elif key == "VECTORS":
            kind = "VECTORS"
            dtype = _VTK_TO_NP[tok[2]]
            ncomp = 3
            break
        elif key in ("CELL_DATA", "FIELD"):
            raise ValueError(f"ReadImage: unsupported vtk attribute in {path}")

    if dims is None or npoints is None or kind is None:
        raise ValueError(f"ReadImage: corrupt vtk header in {path}")
    nx, ny, nz = dims
    count = npoints * ncomp

    if fmt == "BINARY":
        data = np.frombuffer(raw, dtype=dtype, count=count, offset=pos).astype(
            np.dtype(dtype).newbyteorder("=")
        )
    else:
        data = np.array(raw[pos:].split()[:count], dtype=float)
    data = data.reshape(nz, ny, nx, ncomp) if ncomp > 1 else data.reshape(nz, ny, nx)
    if nz == 1 and ncomp == 1:
        data = data[0]
    return Image(
        data=data,
        spacing=spacing or (1.0, 1.0, 1.0),
        origin=origin or (0.0, 0.0, 0.0),
        ncomponents=ncomp,
    )


def write_vtk(img: Image, path: str, binary: bool = True) -> None:
    """Write legacy VTK STRUCTURED_POINTS (binary big-endian by default,
    matching ITK's writer used by the reference)."""
    data = np.asarray(img.data)
    ncomp = img.ncomponents
    shape = data.shape[:-1] if ncomp > 1 else data.shape
    if len(shape) == 2:
        shape = (1,) + shape  # promote 2-D to one slice
    nz, ny, nx = shape
    spacing = tuple(img.spacing) + (1.0,) * (3 - len(img.spacing))
    origin = tuple(img.origin) + (0.0,) * (3 - len(img.origin))

    if data.dtype not in _NP_TO_VTK:
        data = data.astype(np.float64)
    vtk_type = _NP_TO_VTK[data.dtype]

    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"gpr_tpu\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {nx} {ny} {nz}\n".encode())
        f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n".encode())
        f.write(f"ORIGIN {origin[0]} {origin[1]} {origin[2]}\n".encode())
        f.write(f"POINT_DATA {nx * ny * nz}\n".encode())
        flat = np.ascontiguousarray(data).reshape(-1)
        if ncomp == 3:
            f.write(f"VECTORS displacement {vtk_type}\n".encode())
        else:
            f.write(f"SCALARS intensity {vtk_type} {ncomp}\n".encode())
            f.write(b"LOOKUP_TABLE default\n")
        if binary:
            f.write(flat.astype(flat.dtype.newbyteorder(">")).tobytes())
        else:
            np.savetxt(f, flat.reshape(-1, max(ncomp, 1)), fmt="%.10g")


# ---------------------------------------------------------------------------
# MetaImage (.mha / .mhd)
# ---------------------------------------------------------------------------

_MET_TO_NP = {
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
    "MET_UCHAR": np.uint8,
    "MET_CHAR": np.int8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
}
_NP_TO_MET = {np.dtype(v): k for k, v in _MET_TO_NP.items()}


def read_mha(path: str) -> Image:
    """Read a MetaImage volume (.mha local raw, or .mhd + detached raw),
    optionally zlib-compressed."""
    header = {}
    data_file = None
    offset = None
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                break
            text = line.decode("ascii", "replace").strip()
            if "=" not in text:
                continue
            key, val = (s.strip() for s in text.split("=", 1))
            header[key] = val
            if key == "ElementDataFile":
                data_file = val
                offset = f.tell()
                break

    ndims = int(header.get("NDims", 3))
    dims = [int(v) for v in header["DimSize"].split()][:ndims]
    dtype = _MET_TO_NP[header.get("ElementType", "MET_FLOAT")]
    ncomp = int(header.get("ElementNumberOfChannels", 1))
    spacing = tuple(
        float(v) for v in header.get("ElementSpacing", "1 1 1").split()[:ndims]
    )
    origin = tuple(float(v) for v in header.get("Offset", "0 0 0").split()[:ndims])
    compressed = header.get("CompressedData", "False").lower() == "true"
    msb = header.get("ElementByteOrderMSB", header.get("BinaryDataByteOrderMSB", "False"))
    byteorder = ">" if msb.lower() == "true" else "<"

    if data_file == "LOCAL":
        with open(path, "rb") as f:
            f.seek(offset)
            payload = f.read()
    else:
        raw_path = os.path.join(os.path.dirname(path), data_file)
        with open(raw_path, "rb") as f:
            payload = f.read()
    if compressed:
        payload = zlib.decompress(payload)

    count = int(np.prod(dims)) * ncomp
    arr = np.frombuffer(
        payload, dtype=np.dtype(dtype).newbyteorder(byteorder), count=count
    ).astype(dtype)
    shape = list(reversed(dims))
    if ncomp > 1:
        arr = arr.reshape(*shape, ncomp)
    else:
        arr = arr.reshape(shape)
    return Image(data=arr, spacing=spacing, origin=origin, ncomponents=ncomp)


def write_mha(img: Image, path: str, compressed: bool = False) -> None:
    """Write a local-raw .mha file."""
    data = np.asarray(img.data)
    ncomp = img.ncomponents
    shape = data.shape[:-1] if ncomp > 1 else data.shape
    dims = tuple(reversed(shape))
    ndims = len(dims)
    if data.dtype not in _NP_TO_MET:
        data = data.astype(np.float64)
    spacing = tuple(img.spacing)[:ndims] + (1.0,) * max(0, ndims - len(img.spacing))
    origin = tuple(img.origin)[:ndims] + (0.0,) * max(0, ndims - len(img.origin))

    payload = np.ascontiguousarray(data).tobytes()
    if compressed:
        payload = zlib.compress(payload)
    with open(path, "wb") as f:
        f.write(f"ObjectType = Image\nNDims = {ndims}\n".encode())
        f.write(b"BinaryData = True\nBinaryDataByteOrderMSB = False\n")
        f.write(f"CompressedData = {compressed}\n".encode())
        if compressed:
            f.write(f"CompressedDataSize = {len(payload)}\n".encode())
        f.write(("ElementSpacing = " + " ".join(map(str, spacing)) + "\n").encode())
        f.write(("Offset = " + " ".join(map(str, origin)) + "\n").encode())
        f.write(("DimSize = " + " ".join(map(str, dims)) + "\n").encode())
        if ncomp > 1:
            f.write(f"ElementNumberOfChannels = {ncomp}\n".encode())
        f.write(f"ElementType = {_NP_TO_MET[data.dtype]}\n".encode())
        f.write(b"ElementDataFile = LOCAL\n")
        f.write(payload)


# ---------------------------------------------------------------------------
# PNG (PIL) + dispatch
# ---------------------------------------------------------------------------

def read_png(path: str) -> Image:
    from PIL import Image as PILImage

    arr = np.asarray(PILImage.open(path).convert("L"))
    return Image(data=arr, spacing=(1.0, 1.0), origin=(0.0, 0.0), ncomponents=1)


def write_png(img: Image, path: str) -> None:
    from PIL import Image as PILImage

    data = np.asarray(img.data)
    PILImage.fromarray(data.astype(np.uint8)).save(path)


def read_image(path: str) -> Image:
    """Format-dispatching reader (the reference's templated
    ``ReadImage<T>``, itkUtils.h:750-764)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".vtk":
        return read_vtk(path)
    if ext in (".mha", ".mhd"):
        return read_mha(path)
    if ext == ".png":
        return read_png(path)
    raise ValueError(f"ReadImage: unsupported image format {ext!r} ({path})")


def write_image(img: Image, path: str) -> None:
    """Format-dispatching writer (reference ``WriteImage<T>``,
    itkUtils.h:766-796)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".vtk":
        return write_vtk(img, path)
    if ext in (".mha", ".mhd"):
        return write_mha(img, path)
    if ext == ".png":
        return write_png(img, path)
    raise ValueError(f"WriteImage: unsupported image format {ext!r} ({path})")
