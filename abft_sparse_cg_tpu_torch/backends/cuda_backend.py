"""The ``cuda`` target: the hand-written CUDA kernels on ``cuda:0``.

Counterpart of ``abft_sparse_cg_tpu.backends.pallas_backend`` (:160-219),
single device, live detection, unpreconditioned, with the same two
tiers as the TPU package:

  - the whole-solve tier, when ``supports_fused`` holds: kernel B for a
    DIA matrix, D for a banded-ELL one, either with the split tail for a
    bordered split whose tail has a dense plan (solver.fused);
  - otherwise the per-iteration tier: solver.cg's detect-fast /
    repair-rarely loop over the cuda SpmvImpl (ops.spmv_cuda: kernel A,
    C or E per product, ``combine_impls`` of the main's kernel and
    kernel E for a split), re-executing a triggered iteration after the
    repair (solver/cg.py:8-22).  Flat matrices and band splits take this
    tier, as they do on the TPU, whose ``_plan`` has no flat branch and
    whose ``_plan_split`` needs a dense plan (fused.py:390-392).  Its
    loop runs on the host: a few small launches and a host read of rr
    and the trigger per iteration.

``spmv_once`` runs the cuda SpmvImpl's ``full`` — kernel A, C or E in
modes none/constraints, the plain check-and-correct oracle in the ECC
modes, as the reference's ``_wrap_mode`` does.

``cuda-<mode>`` is registered only when ``torch.cuda.is_available()``,
the way the reference registers ``cpu`` only when its library is built.
The class itself also runs on a CPU ``device`` (tests), where every
kernel wrapper takes its plain version.
"""

from __future__ import annotations

import torch

from ..ops.spmv import not_ported
from ..ops.spmv_cuda import make_cuda_spmv
from ..solver.cg import make_cg_solver
from ..solver.fused import make_fused_solver, supports_fused
from . import registry
from .torch_backend import TorchBackend

__all__ = ["CudaBackend"]


class CudaBackend(TorchBackend):
    target = "cuda"
    default_reps = 10

    def _solver(self, mat, dtype, max_itrs, conv):
        if dtype != torch.float32:
            raise not_ported(f"a {dtype} solve on the cuda target")
        if supports_fused(mat, dtype):
            return make_fused_solver(mat, self.mode, max_itrs, conv)
        return make_cg_solver(make_cuda_spmv(mat, dtype, self.mode),
                              max_itrs, conv)

    def _spmv_full(self, mat, dtype):
        return make_cuda_spmv(mat, dtype, self.mode).full


def _register():
    from ..ecc.codec import MODES

    if not torch.cuda.is_available():
        return
    for mode in MODES:
        registry.register("cuda", mode, lambda m=mode: CudaBackend(m))


_register()
