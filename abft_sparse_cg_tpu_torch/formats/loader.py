"""Matrix assembly pipeline: read -> symmetrize -> sort -> block-replicate.

A copy of ``abft_sparse_cg_tpu.formats.loader``.

Reproduces the reference program's ``load_sparse_matrix`` semantics
(reference cg.cpp:342-425) exactly, including its quirks:

  - the first number of each entry line is treated as the *column*, the
    second as the *row* (reference cg.cpp:371 reads "%d %d %lg" into
    col,row) — immaterial for the symmetric matrices this solver targets,
    but kept so entry ordering matches;
  - every off-diagonal entry is mirrored unconditionally, regardless of
    the file's declared symmetry (cg.cpp:385-391) — inputs are expected to
    carry one triangle;
  - entries are sorted by (row, col) (cg.cpp:323-340, 394);
  - the sorted block is replicated ``num_blocks`` times along the diagonal
    to scale the problem: N = width * num_blocks (cg.cpp:400-416).

Everything is vectorized NumPy — no per-entry Python loops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..tracing import span
from .mmio import read_coordinate

__all__ = ["AssembledMatrix", "assemble", "load_matrix"]


@dataclass(frozen=True)
class AssembledMatrix:
    """Symmetrized, sorted, block-replicated COO triplets (host arrays)."""

    cols: np.ndarray    # (nnz,) uint32
    rows: np.ndarray    # (nnz,) uint32
    values: np.ndarray  # (nnz,) float64
    N: int
    nnz: int
    block_size: int
    num_blocks: int


@span("formats.assemble")
def assemble(cols, rows, values, width: int, num_blocks: int) -> AssembledMatrix:
    """Symmetrize + sort + replicate raw 0-based triplets of one block."""
    cols = np.asarray(cols, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)

    # Mirror every off-diagonal entry (reference cg.cpp:385-391).
    offdiag = cols != rows
    cols_s = np.concatenate([cols, rows[offdiag]])
    rows_s = np.concatenate([rows, cols[offdiag]])
    vals_s = np.concatenate([values, values[offdiag]])

    # Sort by (row, col) (reference compare_matrix_elements, cg.cpp:323).
    order = np.lexsort((cols_s, rows_s))
    cols_s, rows_s, vals_s = cols_s[order], rows_s[order], vals_s[order]

    # Replicate the block num_blocks times along the diagonal.
    block_nnz = cols_s.shape[0]
    j = np.repeat(np.arange(num_blocks, dtype=np.int64), block_nnz)
    cols_r = np.tile(cols_s, num_blocks) + j * width
    rows_r = np.tile(rows_s, num_blocks) + j * width
    vals_r = np.tile(vals_s, num_blocks)

    N = width * num_blocks
    return AssembledMatrix(
        cols=cols_r.astype(np.uint32),
        rows=rows_r.astype(np.uint32),
        values=vals_r,
        N=N,
        nnz=cols_r.shape[0],
        block_size=width,
        num_blocks=num_blocks,
    )


def load_matrix(path: str, num_blocks: int) -> AssembledMatrix:
    """Load an MM file and assemble it the way the reference program does."""
    hdr, first, second, values = read_coordinate(path)
    if hdr.rows != hdr.cols:
        raise ValueError("Matrix is not square")
    # Reference quirk: first field = column, second = row (cg.cpp:371).
    return assemble(first, second, values, hdr.rows, num_blocks)
