"""Checkpoint / resume for long solves.

Counterpart of ``abft_sparse_cg_tpu.solver.checkpoint``.  The solvers
are segmented already (a continue function advances a ``CGState`` to an
iteration bound), so a checkpoint is the state: (x, r, p, rr, rz, itr),
the accumulated ABFT stats and the residual trace, written with NumPy
(``.npz``) under the JAX package's field names and types, so that a
snapshot either package writes resumes in the other.

    runner = CheckpointedSolve(impl, conv=1e-3, every=100, path="ck.npz")
    result = runner.run(md, b, max_itrs=10_000)          # saves every 100
    result = runner.run(md, b, max_itrs=10_000, resume=True)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.spmv import SpmvStats
from ..tracing import span
from .cg import CGResult, CGState, init_state, make_cg_continue, trace_length

__all__ = ["save_state", "load_state", "CheckpointedSolve"]

_FIELDS = ("itr", "x", "r", "p", "rr", "rz", "trace")
_STAT_FIELDS = SpmvStats._fields


def save_state(path: str, state: CGState):
    """Write ``state`` to ``path`` atomically (``.tmp.npz``, then
    ``os.replace``): the counters as int32 scalars, as the JAX state
    holds them, the vectors in their dtype."""
    arrays = {"itr": np.int32(state.itr)}
    for f in _FIELDS[1:]:
        arrays[f] = getattr(state, f).detach().cpu().numpy()
    for f in _STAT_FIELDS:
        arrays[f"stats_{f}"] = np.int32(getattr(state.stats, f))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path: str, dtype=None, device="cpu") -> CGState:
    """The ``CGState`` in ``path`` on ``device``; the vectors and scalars
    cast to ``dtype`` when given."""
    with np.load(path) as z:
        def vec(a):
            t = torch.from_numpy(np.array(a))
            return t.to(device=device, dtype=dtype or t.dtype)

        stats = SpmvStats(**{f: int(z[f"stats_{f}"]) for f in _STAT_FIELDS})
        return CGState(itr=int(z["itr"]), x=vec(z["x"]), r=vec(z["r"]),
                       p=vec(z["p"]), rr=vec(z["rr"]), rz=vec(z["rz"]),
                       stats=stats, trace=vec(z["trace"]))


class CheckpointedSolve:
    """Drive a solve in segments, snapshotting state between them."""

    def __init__(self, impl, conv_threshold: float, every: int, path: str,
                 continue_fn=None, state_put=None):
        """``continue_fn`` overrides the solver loop: any callable with
        ``make_cg_continue``'s contract ``(md, state, upto, minv) ->
        (state, md)``, e.g. ``solver.fused.make_fused_continue`` for
        kernels B and D (``impl`` may be None then), or ``make_cg_continue``
        over a sharded SpmvImpl.  ``state_put`` places the (x, r, p) of a
        resumed state from the host (a snapshot is .npz), as a
        mesh-sharded solve needs (its shards' rows onto their devices);
        without it they load onto ``b``'s device.  A fresh state takes
        its placement from ``b``."""
        self.every = int(every)
        self.path = path
        self.state_put = state_put
        if continue_fn is None:
            continue_fn = make_cg_continue(impl, conv_threshold)
        self._cont = continue_fn

    @span("solver.solve")
    def run(self, md, b, max_itrs: int, resume: bool = False,
            minv=None) -> CGResult:
        if resume and os.path.exists(self.path):
            # With ``state_put`` the vectors stay on the host until it
            # places them (a mesh's shards each get their own rows).
            state = load_state(self.path, b.dtype,
                               "cpu" if self.state_put else b.device)
            state = state._replace(rr=state.rr.to(b.device),
                                   rz=state.rz.to(b.device),
                                   trace=state.trace.to(b.device))
            # The snapshot's trace is sized for the run that wrote it:
            # resuming with another max_itrs grows it (nan) or cuts it.
            tlen = trace_length(max_itrs)
            cur = state.trace.shape[0]
            if cur < tlen:
                pad = torch.full((tlen - cur,), float("nan"),
                                 dtype=state.trace.dtype, device=b.device)
                state = state._replace(trace=torch.cat([state.trace, pad]))
            elif cur > tlen:
                state = state._replace(trace=state.trace[:tlen])
            if self.state_put is not None:
                state = state._replace(x=self.state_put(state.x),
                                       r=self.state_put(state.r),
                                       p=self.state_put(state.p))
        else:
            state = init_state(b, max_itrs, minv)

        while state.itr < max_itrs and state.stats.errcode == 0:
            upto = min(state.itr + self.every, max_itrs)
            # The returned md carries any scrub forward, so a persistent
            # fault classifies once per solve, not once per segment.
            state, md = self._cont(md, state, upto, minv)
            save_state(self.path, state)
            if state.itr < upto or state.stats.errcode != 0:
                break  # converged or fail-stopped inside the segment

        return CGResult(x=state.x, iterations=state.itr, rr=state.rr,
                        stats=state.stats, rr_trace=state.trace, md=md)
