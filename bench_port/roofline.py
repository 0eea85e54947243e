"""The bytes a protected CG solve must move, and the card's peak.

Frozen copy of the count in PERF.md §2, as ``chip_smoke.py`` computes
it (``dia_iter_bytes``, ``lazy_bytes``, ``HBM_BPS``): one iteration over
a matrix of D diagonals and N rows reads the D value planes and, in the
ECC modes, the D signal (fold) planes, and moves 8 vector streams (p
read, w written and read, r read and written, x read and written, p
written), each byte counted once.  A lazy solve (check interval K > 1)
streams the signal planes only on its checked iterations and in its exit
pass, and writes its snapshot (seeded from the entry state, refreshed on
every checked iteration).  The count is a function of the matrix and the
schedule alone: it is the same whatever kernels do the work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

HBM_BPS = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
ECC_MODES = ("sed", "sec7", "sec8", "secded")
# A matrix counts as diagonal-structured where its diagonals, stored
# whole, take at most this multiple of its entries (the DIA rule of the
# reference's build).
_DIA_MAX_EXPAND = 4.0


class Shape(NamedTuple):
    n: int           # rows
    nnz: int         # stored entries of the whole (mirrored) matrix
    diagonals: int   # distinct diagonals


def shape(triangle, num_blocks: int) -> Shape:
    """The shape of the matrix the triangle and ``-b`` describe, counted
    from the triplets themselves."""
    rows, cols, _, n = triangle
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    off = rows != cols
    block_nnz = rows.size + int(off.sum())
    d = np.unique(rows[off] - cols[off]).size * 2 + int((~off).any())
    return Shape(n * num_blocks, block_nnz * num_blocks, d)


def dia_iter_bytes(s: Shape, mode: str) -> int:
    """Bytes one iteration must move over the matrix's D diagonals."""
    d = s.diagonals
    return (4 * d + (4 * d if mode in ECC_MODES else 0) + 8 * 4) * s.n


def lazy_bytes(k: int, ci: int, none_b: int, sig_b: int, n: int) -> int:
    """Bytes a lazy solve of k iterations must move: k iterations
    without signals, the signal planes on the checked ones and in the
    exit pass, and the snapshot."""
    checked = [i for i in range(k) if i % ci == ci - 1]
    exit_pass = bool(k) and (not checked or checked[-1] + 1 != k)
    return (k * none_b + (len(checked) + exit_pass) * sig_b
            + 4 * n * (6 + 3 * len(checked)))


def solve_bytes(s: Shape, mode: str, iterations: int,
                check_interval: int = 1):
    """Bytes one solve of ``iterations`` iterations must move, or None
    where the matrix is not diagonal-structured (no count is kept for
    other matrices yet)."""
    if s.diagonals * s.n > _DIA_MAX_EXPAND * max(s.nnz, 1):
        return None
    full = dia_iter_bytes(s, mode)
    if check_interval > 1 and mode in ECC_MODES:
        none_b = dia_iter_bytes(s, "none")
        return lazy_bytes(iterations, check_interval, none_b, full - none_b,
                          s.n)
    return iterations * full
