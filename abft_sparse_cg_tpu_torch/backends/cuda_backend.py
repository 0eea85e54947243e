"""The ``cuda`` target: the hand-written CUDA kernels on ``cuda:0``.

Counterpart of ``abft_sparse_cg_tpu.backends.pallas_backend`` (:65-291),
single device, live detection: the unpreconditioned standard solve runs
in a whole-solve kernel (solver.fused) — B for a DIA matrix, D for a
banded-ELL one; every input this target accepts (DIA, or ELL with K <=
512, float32) lies inside their envelope, so the reference's
per-iteration tier has no counterpart here yet; ``spmv_once`` runs the
cuda SpmvImpl's ``full`` — kernel A or C in modes none/constraints, the
plain check-and-correct oracle in the ECC modes, as the reference's
``_wrap_mode`` does.

``cuda-<mode>`` is registered only when ``torch.cuda.is_available()``,
the way the reference registers ``cpu`` only when its library is built.
The class itself also runs on a CPU ``device`` (tests), where every
kernel wrapper takes its plain version.
"""

from __future__ import annotations

import torch

from ..ops.spmv import not_ported
from ..ops.spmv_cuda import make_cuda_spmv
from ..solver.fused import make_fused_solver, supports_fused
from . import registry
from .torch_backend import TorchBackend

__all__ = ["CudaBackend"]


class CudaBackend(TorchBackend):
    target = "cuda"
    default_reps = 10

    def _solver(self, mat, dtype, max_itrs, conv):
        if not supports_fused(mat, dtype):
            raise not_ported(f"a {dtype} solve of the {mat.exec_kind!r} "
                             "layout on the cuda target")
        return make_fused_solver(mat, self.mode, max_itrs, conv)

    def _spmv_full(self, mat, dtype):
        return make_cuda_spmv(mat, dtype, self.mode).full


def _register():
    from ..ecc.codec import MODES

    if not torch.cuda.is_available():
        return
    for mode in MODES:
        registry.register("cuda", mode, lambda m=mode: CudaBackend(m))


_register()
