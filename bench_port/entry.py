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

Each answer carries the device matrix the solve ended on
(``CGResult.md``): the resident one, or after a repair the scrubbed
copy that ``solver/fused.py::make_fused_continue`` adopted, which the
next request must get.  ``injector`` is the fault traffic's hand: it
flips bits of one stored element in the resident word planes, as
``inject.py::inject_bitflips`` does on the host before an upload.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
from abft_sparse_cg_tpu_torch.ecc.codec import ECC_MODES, narrow, widen
from abft_sparse_cg_tpu_torch.ecc.fold import fold_words
from abft_sparse_cg_tpu_torch.ecc.layout import ECC_COL_MASK
from abft_sparse_cg_tpu_torch.ecc.values import planes_to_value
from abft_sparse_cg_tpu_torch.formats.loader import assemble
from abft_sparse_cg_tpu_torch.formats.protected import build_protected
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
from abft_sparse_cg_tpu_torch.solver.fused import fused_cg_dia, fused_cg_ell

_DTYPES = {"float32": torch.float32}


class Answer(NamedTuple):
    """What a request gets back: x on the device in the matrix's row
    order, the iteration count, r.r and ABFT status on the host (with
    the exec slot and the bit of the first correction, -1 for none),
    and the device matrix for the next request."""

    x: torch.Tensor
    iterations: int
    rr: float
    errcode: int
    corrected: int
    first_cor_slot: int = -1
    first_cor_bit: int = -1
    md: object = None


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
        st = res.stats
        ans = Answer(x, int(res.iterations), float(res.rr),
                     int(st.errcode), int(st.corrected_count),
                     int(st.first_cor_slot), int(st.first_cor_bit), res.md)
        sync(device)
        return ans

    return solve


class Injector:
    """``inject(md, element, bits) -> md``: the global ``bits`` (the
    reference injector's numbering) of stored element ``element`` flipped
    in the resident word planes, in place, and that slot's derived
    entries (``values``, ``fold``, and ``gidx`` where present) derived
    again from its words, as ``make_matrix_device`` derives them.  The
    stored checksums (``cksum``, ``fold_ck``) are encode-time data and
    stay.  The element-to-exec-slot map is the host matrix's
    ``ell_slot`` (nnz int64: 238 MB of host memory at HPCG 104^3); no
    device memory is added.  ``slot(element)`` is where a flip lands."""

    def __init__(self, mat, config):
        if mat.exec_kind not in ("dia", "ell"):
            raise ValueError(f"no device flip for a {mat.exec_kind!r} "
                             "matrix")
        names = mat.layout.word_names
        self.slot_of = mat.ell_slot
        self.nnz, self.n = mat.nnz, mat.N
        self.vlo, self.vhi = names.index("value_lo"), names.index("value_hi")
        self.gather = names.index(mat.ell_gather_word)
        self.mask = (config["mode"] in ECC_MODES
                     and mat.ell_gather_word == "col")
        self.dtype = _DTYPES[config["dtype"]]

    def slot(self, element: int) -> int:
        return int(self.slot_of[element])

    def __call__(self, md, element: int, bits):
        s = self.slot(element)
        one = slice(s, s + 1)
        words = [w.view(-1) for w in md.words]
        for b in bits:
            w, bit = divmod(int(b), 32)
            words[w][one] ^= (1 << bit) - (1 << 32 if bit == 31 else 0)
        wide = [widen(w[one]) for w in words]
        md.values.view(-1)[one] = planes_to_value(
            wide[self.vlo], wide[self.vhi], self.dtype)
        if md.fold is not None:
            md.fold.view(-1)[one] = narrow(fold_words(wide))
        if md.gidx is not None:
            g = wide[self.gather]
            if self.mask:
                g = g & int(ECC_COL_MASK)
            md.gidx.view(-1)[one] = md.perm_pos[
                g.clamp(0, self.n - 1)].to(torch.int32)
        return md


def planes(md) -> dict:
    """The resident planes of a device matrix by name (a word plane as
    ``words.<i>``), the value plane as its int32 bit patterns: equal
    planes are equal bit for bit."""
    out = {}
    for name, t in md._asdict().items():
        items = ([(f"{name}.{i}", p) for i, p in enumerate(t)]
                 if isinstance(t, tuple) else [(name, t)])
        for k, p in items:
            if p is not None:
                out[k] = p.view(torch.int32) if p.is_floating_point() else p
    return out


def launch_counts():
    """Launches of the whole-solve kernels, as the program counts them."""
    return {"fused_cg_dia": fused_cg_dia.launches,
            "fused_cg_ell": fused_cg_ell.launches}
