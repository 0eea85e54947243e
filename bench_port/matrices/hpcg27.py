"""HPCG's problem: the 27-point stencil on an nx x ny x nz grid.

As HPCG's reference code builds it (``GenerateProblem_ref``): row
``ix + nx*iy + nx*ny*iz`` couples to every grid point at distance at most
1 in each coordinate that lies inside the grid, with -1 off the diagonal
and 26 on it.  HPCG's shipped ``hpcg.dat`` sets the local grid to
104 x 104 x 104.
"""

import numpy as np


def triangle(nx=104, ny=104, nz=104, diag=26.0, off=-1.0):
    """The lower triangle (the diagonal and the 13 neighbours of smaller
    index) of the stencil matrix, n = nx*ny*nz."""
    n = nx * ny * nz
    rows, cols, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                d = dz * nx * ny + dy * nx + dx
                if d > 0:
                    continue
                iz = np.arange(max(0, -dz), nz - max(0, dz), dtype=np.int64)
                iy = np.arange(max(0, -dy), ny - max(0, dy), dtype=np.int64)
                ix = np.arange(max(0, -dx), nx - max(0, dx), dtype=np.int64)
                r = np.add.outer(np.add.outer(iz * (nx * ny), iy * nx),
                                 ix).ravel()
                rows.append(r)
                cols.append(r + d)
                vals.append(np.full(r.size, float(diag if d == 0 else off)))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n
