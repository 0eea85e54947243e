"""roofline.py against counts made by hand."""

import pytest

from bench_port import roofline
from bench_port.matrices import hpcg27

from .test_matrices import tridiagonal

TRI = roofline.Shape(8_192_000, 24_575_800, 3)
HPCG = roofline.Shape(1_124_864, 29_791_000, 27)


def test_tridiagonal_shape_by_hand():
    # 81,920 diagonal entries and 81,919 below it, mirrored, 100 blocks.
    assert roofline.shape(tridiagonal(81_920), 100) == TRI


@pytest.mark.parametrize("nx, ny, nz", [(6, 6, 6), (5, 4, 3)])
def test_hpcg_shape_by_hand(nx, ny, nz):
    s = roofline.shape(hpcg27.triangle(nx, ny, nz), 1)
    assert s == (nx * ny * nz, (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2),
                 27)


@pytest.mark.parametrize("shape, mode, its, ci, expect", [
    # (4 B values + 4 B signals) x 3 diagonals + 8 vectors x 4 B = 56 B/row
    (TRI, "secded", 9, 1, 9 * 56 * 8_192_000),
    (TRI, "none", 9, 1, 9 * 44 * 8_192_000),
    # 27 diagonals: 108 + 108 + 32 = 248 B/row
    (HPCG, "secded", 50, 1, 50 * 248 * 1_124_864),
    # Lazy, CI 32, 50 it: 50 x 140 B/row, the signal planes at iteration
    # 32 and in the exit pass (2 x 108), the snapshot 4 x (6 + 3) B/row.
    (HPCG, "secded", 50, 32, (50 * 140 + 2 * 108 + 36) * 1_124_864),
    # Lazy, CI 32, 64 it: checked at 32 and 64, the exit pass is the
    # 64th iteration's check.
    (HPCG, "secded", 64, 32, (64 * 140 + 2 * 108 + 4 * 12) * 1_124_864),
    # Lazy has no meaning without signals.
    (HPCG, "none", 50, 32, 50 * 140 * 1_124_864),
])
def test_solve_bytes_by_hand(shape, mode, its, ci, expect):
    assert roofline.solve_bytes(shape, mode, its, ci) == expect


def test_no_count_for_a_matrix_without_diagonal_structure():
    assert roofline.solve_bytes(roofline.Shape(1000, 3000, 500), "secded",
                                9) is None
