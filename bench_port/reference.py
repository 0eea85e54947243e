"""The plain reference: conjugate gradients in float64, in plain PyTorch.

It imports nothing of the program and nothing of JAX, and takes nothing
the program made: it mirrors and block-replicates the same stored
triangle the program is given, as the reference program's loader does
(every off-diagonal entry mirrored; the block repeated ``num_blocks``
times along the diagonal), and multiplies by a gather and an
``index_add_`` over the entries.  The iteration is the reference
program's unpreconditioned CG (x0 = 0, r = p = b), run while
``itr < max_itrs`` and ``r.r > conv``.  ``dtype`` is float64 for the
reference; the control runs the same code in bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Matrix(NamedTuple):
    rows: torch.Tensor   # (nnz,) int64
    cols: torch.Tensor   # (nnz,) int64
    vals: torch.Tensor   # (nnz,) in the solve's dtype
    n: int


class Solution(NamedTuple):
    x: torch.Tensor
    iterations: int
    rr: float


def assemble(triangle, num_blocks: int, device, dtype=torch.float64) -> Matrix:
    """The whole matrix from one stored triangle of one block."""
    rows, cols, vals, n = triangle
    r = torch.as_tensor(rows, dtype=torch.int64).to(device)
    c = torch.as_tensor(cols, dtype=torch.int64).to(device)
    v = torch.as_tensor(vals, dtype=torch.float64).to(device)
    off = r != c
    r, c, v = (torch.cat([r, c[off]]), torch.cat([c, r[off]]),
               torch.cat([v, v[off]]))
    shift = torch.arange(num_blocks, dtype=torch.int64, device=device) * n
    rows_all = (shift[:, None] + r[None, :]).reshape(-1)
    cols_all = (shift[:, None] + c[None, :]).reshape(-1)
    vals_all = v.repeat(num_blocks).to(dtype)
    return Matrix(rows_all, cols_all, vals_all, n * num_blocks)


def spmv(a: Matrix, x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x).index_add_(0, a.rows, a.vals * x[a.cols])


def cg(a: Matrix, b: torch.Tensor, max_itrs: int, conv: float) -> Solution:
    """CG on ``a`` from x0 = 0 in the dtype of ``a.vals``."""
    dt = a.vals.dtype
    b = b.to(dt)
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rr = torch.dot(r, r)
    itr = 0
    while itr < max_itrs and float(rr) > conv:
        w = spmv(a, p)
        alpha = rr / torch.dot(p, w)
        x = x + alpha * p
        r = r - alpha * w
        rr1 = torch.dot(r, r)
        p = r + (rr1 / rr) * p
        rr = rr1
        itr += 1
    return Solution(x, itr, float(rr))
