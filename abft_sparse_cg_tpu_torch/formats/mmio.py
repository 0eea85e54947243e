"""Matrix Market I/O — native-accelerated reader, NumPy writer.

A copy of ``abft_sparse_cg_tpu.formats.mmio``; both use the same
``native/libmmio_fast.so`` at the repository root.

Covers the MM subset the framework needs (and the reference library
provides, reference mmio.c): ``matrix coordinate real|integer|pattern
general|symmetric|skew-symmetric`` and ``matrix array real|integer``.
The coordinate body parses through ``native/mmio_fast.cpp``
(std::from_chars over OpenMP chunks, ~GB/s) when the library builds;
anything the native parser declines — odd syntax, entry-count mismatch,
unbuildable toolchain — falls back to np.loadtxt (~20 MB/s measured),
which accepts or raises exactly as before.  ``ABFT_NO_NATIVE_MMIO=1``
forces the fallback.

Banner / size-line handling mirrors the reference's
``mm_read_mtx_crd_size`` (reference mmio.c:192-221): ``%`` comment lines
between banner and size line are skipped.
"""

from __future__ import annotations

import ctypes as ct
import io
import os
import subprocess
from dataclasses import dataclass

import numpy as np

__all__ = ["MMHeader", "read_coordinate", "write_coordinate"]

BANNER = "%%MatrixMarket"


@dataclass(frozen=True)
class MMHeader:
    object: str      # matrix
    format: str      # coordinate | array
    field: str       # real | integer | pattern | complex
    symmetry: str    # general | symmetric | skew-symmetric | hermitian
    rows: int
    cols: int
    nnz: int         # entry count (coordinate) or rows*cols (array)
    data_offset: int  # byte offset where entries start


def _parse_banner_and_size(f) -> MMHeader:
    line = f.readline()
    if isinstance(line, bytes):
        line = line.decode()
    parts = line.split()
    if len(parts) != 5 or parts[0] != BANNER:
        raise ValueError(f"not a MatrixMarket file (banner: {line!r})")
    _, obj, fmt, field, sym = (p.lower() for p in parts)
    if obj != "matrix":
        raise ValueError(f"unsupported MM object: {obj}")
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported MM format: {fmt}")

    # Skip % comment lines, then read the size line.
    while True:
        line = f.readline()
        if isinstance(line, bytes):
            line = line.decode()
        if not line:
            raise ValueError("unexpected EOF before MM size line")
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        break

    nums = s.split()
    if fmt == "coordinate":
        if len(nums) != 3:
            raise ValueError(f"bad coordinate size line: {s!r}")
        rows, cols, nnz = (int(x) for x in nums)
    else:
        if len(nums) != 2:
            raise ValueError(f"bad array size line: {s!r}")
        rows, cols = (int(x) for x in nums)
        nnz = rows * cols

    return MMHeader(obj, fmt, field, sym, rows, cols, nnz, f.tell())


_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_FAST_SO = os.path.join(_NATIVE_DIR, "libmmio_fast.so")
_fast_lib = None  # None = not tried, False = unavailable


def _load_fast_lib():
    global _fast_lib
    if os.environ.get("ABFT_NO_NATIVE_MMIO"):
        return None  # checked before the cache: tests flip this per-case
    if _fast_lib is not None:
        return _fast_lib or None
    try:
        src = os.path.join(_NATIVE_DIR, "mmio_fast.cpp")
        if not os.path.exists(_FAST_SO) or (
            os.path.getmtime(_FAST_SO) < os.path.getmtime(src)
        ):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s", "libmmio_fast.so"],
                check=True, capture_output=True, timeout=120,
            )
        lib = ct.CDLL(_FAST_SO)
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.mm_parse_coordinate.restype = ct.c_int64
        lib.mm_parse_coordinate.argtypes = [
            ct.c_char_p, ct.c_int64, ct.c_int64, ct.c_int,
            i64p, i64p, ct.c_void_p,
        ]
        _fast_lib = lib
    except (OSError, subprocess.SubprocessError, FileNotFoundError):
        _fast_lib = False
    return _fast_lib or None


def _native_parse_body(path: str, hdr: MMHeader, ncols: int):
    """Parse the coordinate body natively; None -> caller falls back."""
    lib = _load_fast_lib()
    if lib is None:
        return None
    import mmap

    with open(path, "rb") as f:
        body_len = os.fstat(f.fileno()).st_size - hdr.data_offset
        if body_len <= 0:
            return None
        # Zero-copy body view: mmap the file, point past the header.
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    raw = np.frombuffer(mm, dtype=np.uint8)
    try:
        buf_p = ct.c_char_p(raw.ctypes.data + hdr.data_offset)
        i = np.empty(hdr.nnz, np.int64)
        j = np.empty(hdr.nnz, np.int64)
        v = np.empty(hdr.nnz, np.float64) if ncols == 3 else None
        got = lib.mm_parse_coordinate(
            buf_p, body_len, hdr.nnz, ncols, i, j,
            v.ctypes.data_as(ct.c_void_p) if v is not None else None,
        )
    finally:
        del raw
        mm.close()
    if got != hdr.nnz:
        return None  # syntax or count problem: loadtxt owns the verdict
    return i, j, v


def read_coordinate(path: str):
    """Read a coordinate MM file.

    Returns ``(header, i, j, values)`` with ``i``/``j`` 0-based int64 and
    ``values`` float64 (all-ones for pattern matrices).  No symmetry
    expansion is performed — that is the loader's job, because the
    reference applies its own (quirky) expansion regardless of the file's
    declared symmetry (reference cg.cpp:385-391).
    """
    with open(path, "rb") as f:
        hdr = _parse_banner_and_size(f)
        if hdr.format != "coordinate":
            raise ValueError("read_coordinate: file is not coordinate format")
        if hdr.field == "complex":
            raise ValueError("complex matrices are not supported by this solver")
        ncols = 2 if hdr.field == "pattern" else 3

    native = _native_parse_body(path, hdr, ncols)
    if native is not None:
        i, j, v = native
        i = i - 1
        j = j - 1
        values = np.ones(hdr.nnz, np.float64) if v is None else v
    else:
        with open(path, "rb") as f:
            f.seek(hdr.data_offset)
            data = np.loadtxt(
                io.BufferedReader(f), dtype=np.float64, ndmin=2,
                usecols=range(ncols),
            )
        if data.shape[0] != hdr.nnz:
            raise ValueError(
                f"MM entry count mismatch: header says {hdr.nnz}, "
                f"file has {data.shape[0]}"
            )
        i = data[:, 0].astype(np.int64) - 1
        j = data[:, 1].astype(np.int64) - 1
        if hdr.field == "pattern":
            values = np.ones(hdr.nnz, dtype=np.float64)
        else:
            values = np.ascontiguousarray(data[:, 2])
    if hdr.nnz and (
        i.min() < 0 or j.min() < 0 or i.max() >= hdr.rows or j.max() >= hdr.cols
    ):
        raise ValueError("MM entry index out of declared bounds")
    return hdr, i, j, values


def write_coordinate(path, i, j, values, shape, symmetry="general", field=None):
    """Write a coordinate MM file (0-based inputs, written 1-based)."""
    i = np.asarray(i)
    j = np.asarray(j)
    if field is None:
        field = "pattern" if values is None else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{shape[0]} {shape[1]} {len(i)}\n")
        if field == "pattern":
            np.savetxt(f, np.column_stack([i + 1, j + 1]), fmt="%d %d")
        else:
            np.savetxt(
                f,
                np.column_stack([i + 1, j + 1, np.asarray(values)]),
                fmt="%d %d %.17g",
            )
