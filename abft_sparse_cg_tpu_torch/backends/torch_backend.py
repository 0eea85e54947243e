"""The ``torch`` target: plain PyTorch SpMV + CG on the CPU.

Counterpart of ``abft_sparse_cg_tpu.backends.jnp_backend`` (:60-351):
unpreconditioned or Jacobi (the M^-1 set-up of jnp_backend.py:188-229),
the standard or the pipelined solver (solver.pipelined), straight or
segmented with a snapshot between segments (``checkpoint=``,
solver.checkpoint), on one device or, with ``devices=N``, row-sharded
over N shards of a mesh (parallel.sharded; jnp_backend.py:196-216), all
on the CPU for this target.  A corrected solve returns the repaired
planes (``HostResult.scrubbed``, scrub.scrubbed_from_device).  ``time
taken`` is measured on warm runs; the first run (which pays every
one-time cost, a kernel build included on the cuda target) is reported
as the compile time; a checkpointed solve runs once.  Like the jnp
target, it has no lazy ``--check-interval`` schedule: it warns once and
runs live (``warn_live_schedule``, jnp_backend.py:29-51).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..device import compute_dtype, target_device
from ..ops.spmv import make_matrix_device, make_spmv
from ..parallel.sharded import (
    _device_put_sharded,
    default_mesh,
    make_sharded_continue,
    mesh_rows,
    sharded_spmv,
)
from ..parallel.vector import ShardedVector
from ..scrub import scrubbed_from_device
from ..solver.cg import make_cg_continue, solver_of
from ..solver.checkpoint import CheckpointedSolve
from ..solver.pipelined import make_pipelined_solver
from . import registry
from .base import Backend, HostResult, stats_to_messages

__all__ = ["TorchBackend", "warn_live_schedule", "jacobi_minv"]

_warned_live = set()


def warn_live_schedule(route, check_interval):
    """Warn once per route per process when a check interval > 1 asks
    for a lazy schedule that ``route`` does not have, and it runs live
    (jnp_backend.py:29-51; 'auto' never warns)."""
    try:
        ci = int(check_interval or 1)
    except ValueError:
        return
    if ci > 1 and route not in _warned_live:
        _warned_live.add(route)
        print(f"warning: --check-interval has no lazy schedule on the "
              f"{route} route; running the live detection schedule",
              file=sys.stderr)


def jacobi_minv(mat, precond) -> np.ndarray:
    """The canonical (N,) Jacobi M^-1 of ``-p jacobi`` (1 where the
    diagonal is zero), or None for ``-p none`` (jnp_backend.py:188-193)."""
    if precond == "none":
        return None
    if precond != "jacobi":
        raise ValueError(f"unknown preconditioner: {precond!r}")
    d = mat.diagonal()
    return np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 1.0)


def _placer(bdev):
    """``put(v)``: an exec-order vector of a snapshot (a host tensor)
    placed as ``bdev`` is, whole on its device or row-sharded over its
    shards (ShardedVector.scatter).  A snapshot written at another shard
    count may carry fewer or more zero pad rows past R: they are cut or
    zero-filled to ``bdev``'s rows, so snapshots resume at any shard
    count."""
    R = bdev.shape[0]

    def put(v):
        v = v.to(bdev.dtype)
        if v.shape[0] != R:
            if bool(v[R:].any()):
                raise ValueError(f"a snapshot of {v.shape[0]} rows does not "
                                 f"fit a solve of {R}")
            v = torch.cat([v[:R], v.new_zeros(max(0, R - v.shape[0]))])
        if isinstance(bdev, ShardedVector):
            return ShardedVector.scatter(v, bdev.devices)
        return v.to(bdev.device)

    return put


class TorchBackend(Backend):
    target = "torch"
    default_reps = 1

    def __init__(self, mode: str, device=None):
        self.mode = mode
        self.device = (target_device(self.target) if device is None
                       else torch.device(device))

    # -- per-target routing (overridden by the cuda target) -------------

    def _continue(self, mat, dtype, conv, precond=False,
                  check_interval=None, mesh=None):
        """The segment function of a standard solve (solver.cg's
        ``continue_`` contract), on ``mesh`` when given: what a straight
        solve and a ``--checkpoint`` segment both run (jnp_backend.py:
        99-107)."""
        warn_live_schedule(self.target, check_interval)
        if mesh is not None:
            return make_sharded_continue(mat, mesh, conv, dtype, self.mode)
        return make_cg_continue(make_spmv(mat, dtype, self.mode), conv)

    def _spmv_impl(self, mat, dtype, mesh=None):
        """The per-iteration SpmvImpl: the pipelined solver's product and
        ``spmv_once``'s ``full``."""
        if mesh is not None:
            return sharded_spmv(mat, mesh, dtype, self.mode)
        return make_spmv(mat, dtype, self.mode)

    def _pipelined_ci(self, check_interval):
        """The pipelined solver has no lazy schedule: warn as -t jnp does
        (jnp_backend.py:29-51)."""
        warn_live_schedule(self.target, check_interval)

    def _solver(self, mat, dtype, max_itrs, conv, precond=False,
                check_interval=None, mesh=None, solver="standard"):
        """``solve(md, b, minv=None) -> CGResult``: ``solver`` "standard"
        (``_continue`` to the limit) or "pipelined" (over ``_spmv_impl``,
        pallas_backend.py:162-165)."""
        if solver == "pipelined":
            self._pipelined_ci(check_interval)
            return make_pipelined_solver(self._spmv_impl(mat, dtype, mesh),
                                         max_itrs, conv)
        if solver != "standard":
            raise ValueError(f"unknown solver: {solver!r}")
        return solver_of(self._continue(mat, dtype, conv, precond,
                                        check_interval, mesh), max_itrs)

    def _warm(self):
        """One-time set-up a checkpointed solve reports as compile time."""

    def _mesh(self, devices: int):
        """The mesh of a ``devices``-shard solve: on a card, one shard per
        CUDA card (fewer cards than shards is refused with the JAX
        message, jnp_backend.py:201-205); on the CPU, every shard on it."""
        if self.device.type == "cuda":
            found = torch.cuda.device_count()
            if devices > found:
                raise ValueError(f"requested {devices} devices, found {found}")
            return default_mesh(devices)
        return default_mesh(devices, self.device)

    def _sync(self, mesh=None):
        """Wait for the solve's cards: the target's, or every card of
        ``mesh``, so that ``time taken`` covers them all."""
        devs = mesh.devices if mesh is not None else (self.device,)
        for dev in dict.fromkeys(devs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _exec_vector(self, mat, v, dtype):
        pad = np.zeros(mat.R, dtype=np.float64)
        pad[: mat.N] = mat.to_exec_order(np.asarray(v, dtype=np.float64))
        return torch.tensor(pad, dtype=dtype, device=self.device)

    # -- Backend API ------------------------------------------------------

    def solve(self, mat, b, max_itrs, conv_threshold, dtype="auto",
              reps=0, precond="none", check_interval=None, devices=0,
              solver="standard", want_scrubbed="auto", checkpoint=None,
              checkpoint_every=100, resume=False,
              verbose=True) -> HostResult:
        """``verbose`` is the CLI's ``not --quiet``, which only the cpu
        target's live loop reads (here the CLI prints the rr lines from
        ``rr_trace``); ``precond``: "none" or "jacobi" (M^-1 in exec
        order, zero on pad rows); ``check_interval``: None, an int or
        "auto";
        ``devices`` > 1: row-shard the solve over that many shards;
        ``solver``: "standard" or "pipelined".  ``checkpoint``: the
        snapshot path of the segmented solve (solver.checkpoint), state
        written every ``checkpoint_every`` iterations, ``resume`` from
        the snapshot if present; it runs once (each segment syncs with
        the host).  ``want_scrubbed``: return the repaired planes of a
        corrected solve as ``HostResult.scrubbed`` (True, False, or
        "auto": on the CPU only; jnp_backend.py:170-320)."""
        dt = compute_dtype(self.target, dtype)
        minv_host = jacobi_minv(mat, precond)
        r_dev = mesh = None
        if devices and devices > 1:
            mesh = self._mesh(devices)
            md, bdev, put_vec = _device_put_sharded(mat, b, mesh, dt)
            minv = None if minv_host is None else put_vec(minv_host)
            if mat.exec_kind in ("dia", "ell"):
                # Flat slots are entry positions, which the mesh padding
                # never shifts; a split keeps R (sharded.py).
                r_dev = mesh_rows(mat, mesh.size)
        else:
            minv = (None if minv_host is None
                    else self._exec_vector(mat, minv_host, dt))
            md = make_matrix_device(mat, dt, self.device)
            bdev = self._exec_vector(mat, b, dt)

        if checkpoint:
            if solver != "standard":
                raise ValueError(
                    "--checkpoint requires --solver standard (the "
                    "pipelined recurrence carries state a snapshot cannot "
                    "re-seed)")
            cont = self._continue(mat, dt, conv_threshold, minv is not None,
                                  check_interval, mesh)
            runner = CheckpointedSolve(None, conv_threshold,
                                       checkpoint_every, checkpoint,
                                       continue_fn=cont,
                                       state_put=_placer(bdev))
            t0 = time.perf_counter()
            self._warm()
            t1 = time.perf_counter()
            res = runner.run(md, bdev, max_itrs, resume=resume, minv=minv)
            self._sync(mesh)
            t2 = time.perf_counter()
            reps = 1
        else:
            solve_fn = self._solver(mat, dt, max_itrs, conv_threshold,
                                    minv is not None, check_interval, mesh,
                                    solver)
            t0 = time.perf_counter()
            res = solve_fn(md, bdev, minv)
            self._sync(mesh)
            t1 = time.perf_counter()
            reps = reps or self.default_reps
            for _ in range(reps):
                res = solve_fn(md, bdev, minv)
            self._sync(mesh)
            t2 = time.perf_counter()

        st = res.stats
        msgs, err_index = stats_to_messages(
            mat, st.errcode, st.err_slot, st.first_cor_slot,
            st.first_cor_bit, r_dev=r_dev)
        scrubbed = None
        if st.corrected_count > 0 and (
                want_scrubbed is True
                or (want_scrubbed == "auto" and self.device.type == "cpu")):
            scrubbed = scrubbed_from_device(mat, res.md)
        return HostResult(
            x=mat.from_exec_order(res.x.cpu().numpy()[: mat.N]),
            iterations=int(res.iterations),
            rr=float(res.rr),
            errcode=st.errcode,
            err_index=err_index,
            corrected_count=st.corrected_count,
            corrected_index=st.first_cor_slot,
            corrected_bit=st.first_cor_bit,
            messages=msgs,
            solve_seconds=(t2 - t1) / reps,
            compile_seconds=t1 - t0,
            rr_trace=res.rr_trace.cpu().numpy(),
            scrubbed=scrubbed,
        )

    def spmv_once(self, mat, x, dtype="auto"):
        dt = compute_dtype(self.target, dtype)
        md = make_matrix_device(mat, dt, self.device)
        w, st = self._spmv_impl(mat, dt).full(
            md, self._exec_vector(mat, x, dt))
        msgs, _ = stats_to_messages(mat, st.errcode, st.err_slot,
                                    st.first_cor_slot, st.first_cor_bit)
        return (mat.from_exec_order(w.cpu().numpy()[: mat.N]), st.errcode,
                msgs)


def _register():
    from ..ecc.codec import MODES

    for mode in MODES:
        registry.register("torch", mode, lambda m=mode: TorchBackend(m))


_register()
