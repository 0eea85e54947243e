"""Banded-ELL matrices at the edges of kernel C's schedule, and the row
cut that makes the smallest of them, for the card tests and
chip_smoke.py.

Kernel C (csrc/ell_spmv_detect.cu) takes tiles of ops.spmv.ELL_TILE_ROWS
rows and slabs of ops.spmv.ELL_SLAB slots; its edges are a matrix of one
warp of rows, one slot per row, K not a multiple of the slab, and whole
tiles of empty rows.
"""

from __future__ import annotations

import numpy as np

from ..formats import assemble
from .matgen import spd_tridiagonal

# Rows a case keeps on the card (``cut_rows``): the build pads R to a
# multiple of 128, so a 32-row matrix is cut from a built one.
ROW_CUT = {"R32": 32}


def ell_edge_cases() -> dict:
    """{case: (assembled matrix, build_protected options)}; build each
    with ``force_exec="ell"``:

      - "R32": a tridiagonal of 20 rows (cut to 32 rows on the card);
      - "K1": a diagonal;
      - "K13": 13 diagonals, not a multiple of the 4-slot slab;
      - "empty-tiles": two tridiagonal blocks 1,000 rows apart, R aligned
        to 4096, so whole tiles hold no slot.
    """
    cat = np.concatenate
    r, c, v, n = spd_tridiagonal(20)
    out = {"R32": (assemble(c, r, v, n, 1), {})}
    i = np.arange(4096)
    out["K1"] = (assemble(i, i, np.full(4096, 2.0), 4096, 1), {})
    i = np.arange(4000)
    rows, cols, vals = [i], [i], [np.full(4000, 20.0)]
    for d in range(1, 7):
        rows.append(i[d:])
        cols.append(i[:-d])
        vals.append(-np.ones(4000 - d) / d)
    out["K13"] = (assemble(cat(cols), cat(rows), cat(vals), 4000, 1), {})
    r, c, v, _ = spd_tridiagonal(500)
    out["empty-tiles"] = (
        assemble(cat([c, c + 1500]), cat([r, r + 1500]), cat([v, v]), 2000,
                 1), {"row_align": 4096})
    return out


def cut_rows(md, R: int | None):
    """The MatrixDevice ``md`` cut to its first R rows (contiguous copies),
    or ``md`` itself when R is None."""
    if R is None:
        return md

    def cut(t, per=1):
        return None if t is None else t[..., : R // per].contiguous()

    return md._replace(words=tuple(cut(w) for w in md.words),
                       cksum=cut(md.cksum, 8), values=cut(md.values),
                       fold=cut(md.fold), fold_ck=cut(md.fold_ck, 8),
                       ell_len=cut(md.ell_len), gidx=cut(md.gidx))
