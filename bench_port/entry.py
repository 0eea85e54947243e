"""The system under test: the one file that imports the program.

The matrix goes through the program's normal host path
(``formats/loader.py::assemble`` on the stored triangle, then
``formats/protected.py::build_protected``), is uploaded once with
``ops/spmv.py::make_matrix_device``, and every request runs the solve
the ``cuda`` target routes to (``backends/cuda_backend.py::
CudaBackend._continue`` through ``TorchBackend._solver``) on that
resident device matrix.  The program has no public entry for a solve
against a resident matrix (``TorchBackend.solve`` uploads the matrix
and sends b and x through the host on every call), so this file calls
those two methods directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
from abft_sparse_cg_tpu_torch.formats.loader import assemble
from abft_sparse_cg_tpu_torch.formats.protected import build_protected
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
from abft_sparse_cg_tpu_torch.solver.fused import fused_cg_dia, fused_cg_ell

_DTYPES = {"float32": torch.float32}


class Answer(NamedTuple):
    """What a request gets back: x on the device in the matrix's row
    order, and the iteration count, r.r and ABFT status on the host."""

    x: torch.Tensor
    iterations: int
    rr: float
    errcode: int
    corrected: int


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(triangle, config):
    """The protected matrix of ``config`` from one stored triangle
    (the reference loader reads the first field as the column)."""
    rows, cols, vals, n = triangle
    asm = assemble(cols, rows, vals, n, config["num_blocks"])
    return build_protected(config["format"], asm, config["mode"])


def upload(mat, config, device):
    md = make_matrix_device(mat, _DTYPES[config["dtype"]], device)
    sync(device)
    return md


def prepare(mat, config, traffic, device):
    """``solve(md, b) -> Answer`` for b (N,) float32 on ``device``: the
    kernels built and loaded, b placed in the exec order, x read back
    out of it."""
    backend = CudaBackend(config["mode"], device)
    if device.type == "cuda":
        backend._warm()
    solver = backend._solver(mat, _DTYPES[config["dtype"]],
                             config["max_itrs"], config["conv"],
                             check_interval=traffic["check_interval"])
    n, rows = mat.N, mat.R
    perm = (None if mat.perm is None
            else torch.as_tensor(mat.perm, dtype=torch.int64).to(device))

    def solve(md, b):
        if perm is None and rows == n:
            bx = b
        else:
            bx = torch.zeros(rows, dtype=b.dtype, device=device)
            bx[:n] = b if perm is None else b[perm]
        res = solver(md, bx)
        x = res.x[:n]
        if perm is not None:
            x = torch.empty_like(x).index_copy_(0, perm, x)
        ans = Answer(x, int(res.iterations), float(res.rr),
                     int(res.stats.errcode), int(res.stats.corrected_count))
        sync(device)
        return ans

    return solve


def launch_counts():
    """Launches of the whole-solve kernels, as the program counts them."""
    return {"fused_cg_dia": fused_cg_dia.launches,
            "fused_cg_ell": fused_cg_ell.launches}
