"""Synthetic SPD test-matrix generators.

A copy of ``abft_sparse_cg_tpu.utils.matgen``: the same seeds give the
same matrices in both packages.

The reference ships `make` rules to download shallow_water1 from the UFL
collection (reference matrices/Makefile:7-11), but that URL is dead; the
measured baseline (BASELINE.md) therefore uses a synthetic SPD stand-in.
These generators produce MM files with one stored triangle, matching what
the loader's unconditional mirroring expects.
"""

from __future__ import annotations

import numpy as np

from ..formats.mmio import write_coordinate

__all__ = ["spd_tridiagonal", "spd_laplacian_2d", "spd_wideband",
           "spd_denseband", "shuffle_labels", "write_mm_triangle",
           "row_lengths_assembled"]


def spd_denseband(n: int, half: int, coupling: float = -1.0):
    """Dense band: every row couples to ALL rows within distance
    ``half`` — row degree (and the ELL slot count K) is exactly
    2*half + 1 at a bandwidth of only ``half``.  This is the
    high-degree/narrow-band family (higher-order 3-D FEM: ~100+
    nnz/row) that exercises the ELL kernels' slot-count envelope
    rather than their window size; diagonal = degree + 4 keeps it
    strictly diagonally dominant, hence SPD.  Returns the lower
    triangle as 0-based triplets (rows, cols, vals, n)."""
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    i = np.arange(n)
    for d in range(1, half + 1):
        rows.append(i[d:])
        cols.append(i[:-d])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    off = rows != cols
    deg = (np.bincount(rows[off], minlength=n)
           + np.bincount(cols[off], minlength=n)).astype(float)
    vals = np.where(rows == cols, deg[rows] * abs(coupling) + 4.0,
                    coupling)
    return rows, cols, vals, n


def shuffle_labels(rows, cols, vals, n, seed=0):
    """Apply a random symmetric relabeling to triplets — turns a banded
    matrix into an "unstructured-looking" one (same spectrum, same CG
    behaviour) the way an arbitrary mesh numbering would.  The lower
    triangle is re-established after relabeling."""
    rng = np.random.default_rng(seed)
    relab = rng.permutation(n)
    r2, c2 = relab[rows], relab[cols]
    swap = r2 < c2
    r2[swap], c2[swap] = c2[swap], r2[swap]
    return r2, c2, vals, n


def spd_tridiagonal(n: int, diag: float = 4.0, off: float = -1.0):
    """Tridiagonal SPD matrix; returns one triangle as 0-based triplets.

    Same construction as the measured-baseline stand-in: diag=4, off=-1
    (strictly diagonally dominant -> SPD).
    """
    di = np.arange(n, dtype=np.int64)
    oi = np.arange(n - 1, dtype=np.int64)
    rows = np.concatenate([di, oi + 1])
    cols = np.concatenate([di, oi])
    vals = np.concatenate([np.full(n, diag), np.full(n - 1, off)])
    return rows, cols, vals, n


def spd_laplacian_2d(side: int):
    """5-point 2-D Laplacian on a side x side grid (N = side**2).

    A more realistic stand-in for mesh-based CFD matrices like
    shallow_water1: ~5 nnz/row, two off-diagonal bands at +-1 and +-side.
    Returns the lower triangle (diagonal included) as 0-based triplets.
    """
    n = side * side
    idx = np.arange(n, dtype=np.int64)
    ii, jj = np.divmod(idx, side)

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]

    west = jj > 0
    rows.append(idx[west])
    cols.append(idx[west] - 1)
    vals.append(np.full(west.sum(), -1.0))

    north = ii > 0
    rows.append(idx[north])
    cols.append(idx[north] - side)
    vals.append(np.full(north.sum(), -1.0))

    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


def spd_wideband(n: int, band: int, k: int = 3, seed: int = 2):
    """Uniformly wide band: identity-ish diagonal (30.0) plus ``k``
    random in-band sub-diagonal neighbors per row at distances in
    [1, band) — diagonally dominant after mirroring, so SPD.  At
    production scale RCM cannot reband this family (measured: n=32768
    band=2800 -> RCM band 2556); it exercises the wideband
    (absolute-scan) kernel tiers.  Returns the lower triangle as
    0-based triplets (rows, cols, vals, n)."""
    rng = np.random.default_rng(seed)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    i = np.arange(n)
    for _ in range(k):
        d = rng.integers(1, band, n)
        keep = i + d < n
        rows.append((i + d)[keep])
        cols.append(i[keep])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    # Diagonal: 30.0 where that already dominates (keeps the k<=3 bench
    # matrices bit-identical to earlier versions), else degree + 4 — at
    # k >= 14 a row can collect > 30 unit off-diagonals after mirroring
    # and a fixed 30.0 diagonal loses SPD (measured: k=17 -> p.A.p < 0,
    # CG correctly fail-stops with ERR_BREAKDOWN).
    off = rows != cols
    deg = (np.bincount(rows[off], minlength=n)
           + np.bincount(cols[off], minlength=n)).astype(float)
    diag_val = np.maximum(30.0, deg + 4.0)
    vals = np.where(rows == cols, diag_val[rows], -1.0)
    return rows, cols, vals, n


def write_mm_triangle(path: str, rows, cols, vals, n: int):
    """Write one triangle as a symmetric coordinate MM file.

    Column written first to match the reference reader's field order
    (reference cg.cpp:371 reads col,row) — symmetric, so content-equivalent
    either way.
    """
    write_coordinate(path, cols, rows, vals, (n, n), symmetry="symmetric")


# Rows of 0, 1, 31, 32, 33, 64, 65, 1000, 2048, 2049 and 4100 slots: the
# edges of kernel E's row classes (a thread, a warp, a tile of 2048).
ROW_LENGTH_EDGES = (0, 1, 31, 32, 33, 4100, 2048, 2049, 64, 65, 1000)


def row_lengths_assembled(n: int = 8192, seed: int = 0):
    """An assembled (unsymmetric, not SPD) matrix whose first rows hold
    ``ROW_LENGTH_EDGES`` entries and the rest 0-39, at sorted random
    columns with normal values: a product check for the flat layout
    (``build_protected(..., force_exec="flat")``), never a solve.  The
    port's addition; it bypasses ``assemble``'s mirroring."""
    from ..formats.loader import AssembledMatrix

    rng = np.random.default_rng(seed)
    lengths = np.concatenate([ROW_LENGTH_EDGES,
                              rng.integers(0, 40, n - len(ROW_LENGTH_EDGES))])
    rows = np.repeat(np.arange(n), lengths)
    cols = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                           for k in lengths])
    return AssembledMatrix(
        cols=cols.astype(np.uint32), rows=rows.astype(np.uint32),
        values=rng.standard_normal(len(cols)), N=n, nnz=len(cols),
        block_size=n, num_blocks=1)
