"""The ``cuda`` target: the hand-written CUDA kernels on ``cuda:0``.

Counterpart of ``abft_sparse_cg_tpu.backends.pallas_backend`` (:141-219),
single device, unpreconditioned or Jacobi, live or lazy detection, with
the same two tiers as the TPU package:

  - the whole-solve tier, when ``supports_fused`` holds: kernel B for a
    DIA matrix, D for a banded-ELL one, either with the split tail for a
    bordered split whose tail has a dense plan (solver.fused), in the
    Jacobi and lazy instances as the solve asks;
  - otherwise the per-iteration tier: solver.cg's detect-fast /
    repair-rarely loop over the cuda SpmvImpl (ops.spmv_cuda: kernel A,
    C or E per product, ``combine_impls`` of the main's kernel and
    kernel E for a split), re-executing a triggered iteration after the
    repair (solver/cg.py:8-22); with a check interval > 1, solver.cg's
    lazy loop over the same kernels and their detection-free products
    (``make_cuda_product``).  Flat matrices and band splits take this
    tier, as they do on the TPU, whose ``_plan`` has no flat branch and
    whose ``_plan_split`` needs a dense plan (fused.py:390-392).  Its
    loop runs on the host: a few small launches and a host read of rr
    (and, on a checked iteration, the trigger) per iteration.

``--check-interval auto`` resolves to live (1) on the whole-solve tier
and to 32 on the per-iteration tier (``_check_interval``).  The TPU
policy (pallas_backend.py:27-50) also gives 32 to its streaming
megakernel tier, a VMEM artifact the H100 has no counterpart of: a
decided divergence for matrices past the TPU's resident envelope (DIA
``-b 100``), which changes no output (a clean lazy solve equals the live
one).

With ``devices=N`` a solve is row-sharded over N cards, one shard per
card (pallas_backend.py:72-125): solver.cg's loop over the per-shard
halo forms of kernels A and C inside the kernel envelope
(parallel.sharded_kernel), each shard's planes and vectors on its own
card and only the halo edges copied between cards, on the lazy schedule
with a check interval (``auto``: 32, as there); otherwise the
single-device per-iteration program on the mesh-padded planes on the
first card, live.  A host with fewer cards than N exits 1.  The same
code runs N shards on one card (``parallel.sharded.default_mesh(N,
"cuda:0")``), which is how chip_smoke.py drives it on a one-card host.

Both tiers are one routing (``_continue``), which a ``--checkpoint``
solve runs segment by segment (solver.checkpoint): kernel B or D
launched once per segment from the restored state (and once more after
each repair), or the per-iteration loops to each segment's bound.
``solver="pipelined"`` runs solver.pipelined over the per-iteration
SpmvImpl (kernel A, C or E, or the sharded one; never B or D), live: a
check interval > 1 warns on stderr (pallas_backend.py:57-61).

``spmv_once`` runs the cuda SpmvImpl's ``full`` — kernel A, C or E in
modes none/constraints, the plain check-and-correct oracle in the ECC
modes, as the reference's ``_wrap_mode`` does.

``cuda-<mode>`` is registered only when ``torch.cuda.is_available()``,
the way the reference registers ``cpu`` only when its library is built.
The class itself also runs on a CPU ``device`` (tests), where every
kernel wrapper takes its plain version.
"""

from __future__ import annotations

import sys

import torch

from ..ops.spmv import not_ported
from ..ops.spmv_cuda import make_cuda_product, make_cuda_spmv
from ..parallel.sharded import make_sharded_continue, sharded_spmv
from ..parallel.sharded_kernel import supports_shardmap
from ..solver.cg import make_cg_continue, make_lazy_ci_continue
from ..solver.fused import make_fused_continue, supports_fused
from . import registry
from .torch_backend import TorchBackend, warn_live_schedule

__all__ = ["CudaBackend"]


def _check_interval(check_interval, mat) -> int:
    """The lazy schedule's interval of a solve of ``mat``: None or 1 is
    live; 'auto' is live on the whole-solve tier and 32 on the
    per-iteration tier; an int K is max(1, K) (pallas_backend.py:19-62,
    taken as a parameter instead of ABFT_CHECK_INTERVAL)."""
    if check_interval is None:
        return 1
    if check_interval == "auto":
        return 1 if supports_fused(mat, torch.float32) else 32
    try:
        return max(1, int(check_interval))
    except ValueError:
        raise ValueError(f"check interval must be an integer or 'auto', "
                         f"got {check_interval!r}") from None


class CudaBackend(TorchBackend):
    target = "cuda"
    default_reps = 10

    def _continue(self, mat, dtype, conv, precond=False,
                  check_interval=None, mesh=None):
        """The one routing of a standard solve, straight or in
        ``--checkpoint`` segments (pallas_backend.py:141-219, :222-258):
        kernels B or D when ``supports_fused`` holds, else the
        per-iteration tier, lazy over the products with a check interval
        > 1; on a mesh, parallel.sharded's continue."""
        if dtype != torch.float32:
            raise not_ported(f"a {dtype} solve on the cuda target")
        if mesh is not None:
            if not supports_shardmap(mat, dtype, mesh.size):
                warn_live_schedule("cuda (sharded single-device program)",
                                   check_interval)
                ci = 1
            elif check_interval == "auto":
                ci = 32
            else:
                ci = _check_interval(check_interval, mat)
            return make_sharded_continue(mat, mesh, conv, dtype, self.mode,
                                         check_interval=ci)
        ci = _check_interval(check_interval, mat)
        if supports_fused(mat, dtype, precond, ci):
            return make_fused_continue(mat, self.mode, conv,
                                       precond=precond, check_interval=ci)
        spmv = make_cuda_spmv(mat, dtype, self.mode)
        if ci > 1 and spmv.classify is not None:
            return make_lazy_ci_continue(
                spmv, make_cuda_product(mat, dtype, self.mode), ci, conv)
        return make_cg_continue(spmv, conv)

    def _spmv_impl(self, mat, dtype, mesh=None):
        if dtype != torch.float32:
            raise not_ported(f"a {dtype} solve on the cuda target")
        if mesh is not None:
            return sharded_spmv(mat, mesh, dtype, self.mode)
        return make_cuda_spmv(mat, dtype, self.mode)

    def _pipelined_ci(self, check_interval):
        """The pipelined solver has no lazy variant: a check interval > 1
        warns and runs live, 'auto' resolves to 1 (pallas_backend.py:
        41-42, :57-61)."""
        if check_interval not in (None, "auto") and \
                int(check_interval) > 1:
            print("warning: --check-interval has no pipelined-solver "
                  "variant; running the live detection schedule",
                  file=sys.stderr)

    def _warm(self):
        from .._build import build

        build()


def _register():
    from ..ecc.codec import MODES

    if not torch.cuda.is_available():
        return
    for mode in MODES:
        registry.register("cuda", mode, lambda m=mode: CudaBackend(m))


_register()
