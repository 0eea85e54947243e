"""The matrix families and the plain reference."""

import numpy as np
import pytest
import torch

from bench_port import reference
from bench_port.matrices import hpcg27


def tridiagonal(n):
    """The lower triangle of tridiag(-1, 4, -1)."""
    i = np.arange(n)
    return (np.concatenate([i, i[1:]]), np.concatenate([i, i[:-1]]),
            np.concatenate([np.full(n, 4.0), np.full(n - 1, -1.0)]), n)


def dense(triangle, blocks):
    rows, cols, vals, n = triangle
    a = np.zeros((n, n))
    a[rows, cols] = vals
    a[cols, rows] = vals
    return np.kron(np.eye(blocks), a)


@pytest.mark.parametrize("nx, ny, nz", [(4, 4, 4), (5, 4, 3)])
def test_hpcg27_is_the_27_point_stencil(nx, ny, nz):
    rows, cols, vals, n = hpcg27.triangle(nx, ny, nz)
    assert n == nx * ny * nz
    assert (rows >= cols).all()
    a = dense((rows, cols, vals, n), 1)
    assert np.count_nonzero(a) == ((3 * nx - 2) * (3 * ny - 2)
                                   * (3 * nz - 2))
    assert (np.diag(a) == 26).all()
    # Row ix + nx*iy + nx*ny*iz couples to every grid point within 1.
    idx = np.arange(n)
    ix, iy, iz = idx % nx, idx // nx % ny, idx // (nx * ny)
    near = ((abs(ix[:, None] - ix[None, :]) <= 1)
            & (abs(iy[:, None] - iy[None, :]) <= 1)
            & (abs(iz[:, None] - iz[None, :]) <= 1))
    assert ((a != 0) == near).all()
    assert (a[near & ~np.eye(n, dtype=bool)] == -1).all()


@pytest.mark.parametrize("tri, blocks", [
    (tridiagonal(40), 3),
    (hpcg27.triangle(4, 3, 5), 2),
])
def test_reference_matches_a_direct_solve(tri, blocks):
    a = reference.assemble(tri, blocks, "cpu")
    n = a.n
    b = torch.as_tensor(np.random.default_rng(3).random(n))
    sol = reference.cg(a, b, n, 1e-26)
    x = np.linalg.solve(dense(tri, blocks), b.numpy())
    assert sol.iterations < n
    np.testing.assert_allclose(sol.x.numpy(), x, rtol=1e-10, atol=1e-12)


def test_reference_stops_at_the_limit_and_the_threshold():
    a = reference.assemble(hpcg27.triangle(5, 5, 5), 1, "cpu")
    b = torch.ones(a.n, dtype=torch.float64)
    assert reference.cg(a, b, 7, 0.0).iterations == 7
    full = reference.cg(a, b, 1000, 1e-3)
    assert full.rr <= 1e-3
    assert reference.cg(a, b, 1000, full.rr * 1.0001).iterations <= \
        full.iterations


def test_reference_spmv_mirrors_and_replicates():
    tri = hpcg27.triangle(3, 3, 2)
    a = reference.assemble(tri, 2, "cpu")
    x = torch.as_tensor(np.random.default_rng(1).random(a.n))
    np.testing.assert_allclose(reference.spmv(a, x).numpy(),
                               dense(tri, 2) @ x.numpy(), rtol=1e-14)
