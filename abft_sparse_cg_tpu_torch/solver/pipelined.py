"""Pipelined CG (Ghysels & Vanroose): one reduction point per iteration.

Counterpart of ``abft_sparse_cg_tpu.solver.pipelined`` (see its
docstring for the recurrences).  Both scalars of an iteration come from
one pass over the current state,

    gamma = (r, r);  delta = (w, r);  n = A w        # the only SpMV
    beta  = gamma / gamma_old                        (0 after a restart)
    alpha = gamma / (delta - beta * gamma / alpha_old)
    s = w + beta s;  z = n + beta z;  p = r + beta p
    x += alpha p;  r -= alpha s;  w -= alpha z

with s = A p, z = A s and w = A r.  The SpMV is the SpmvImpl's fast
detection product (or ``full`` without a classify); a trigger discards
the iteration, classifies once, then restarts the recurrences on the
scrubbed matrix (w recomputed, s, z, p reset): products recurred from
corrupt data must not outlive the repair.  ERR_BREAKDOWN guards the
alpha denominator.  The loop runs on the host around device tensors, as
solver.cg's does; it reads gamma, the trigger and the error code back
once per iteration.
"""

from __future__ import annotations

import torch

from ..ops.blas1 import dot
from ..ops.spmv import ERR_BREAKDOWN, SpmvImpl, SpmvStats
from ..tracing import span
from .cg import CGResult, trace_length

__all__ = ["make_pipelined_solver"]


def make_pipelined_solver(impl: SpmvImpl, max_itrs: int,
                          conv_threshold: float):
    """``solve(md, b, minv=None) -> CGResult`` (pipelined.py:42);
    ``minv`` is refused: the pipelined solver is unpreconditioned."""
    lazy = impl.classify is not None
    fast = impl.fast
    if lazy and fast is None:
        def fast(md, x):
            w, trig, _ = impl.fast_pw(md, x)
            return w, trig

    def spmv(md, x):
        """(A x, trigger, stats of a checking product)."""
        if lazy:
            n, trig = fast(md, x)
            return n, bool(trig), SpmvStats.clean()
        n, st = impl.full(md, x)
        return n, st.errcode != 0, st

    @span("solver.solve")
    def solve(md, b, minv=None):
        if minv is not None:
            raise ValueError(
                "the pipelined solver is unpreconditioned; use the "
                "standard solver for -p jacobi")
        conv = torch.tensor(conv_threshold, dtype=b.dtype, device=b.device)
        trace = torch.full((trace_length(max_itrs),), float("nan"),
                           dtype=b.dtype, device=b.device)

        def init(md, itr, x, r, stats):
            """(Re)start the recurrences at the current iterate."""
            w, trig, st = spmv(md, r)
            z = torch.zeros_like(r)
            return dict(itr=itr, x=x, r=r, w=w, s=z, z=z, p=z, g_old=None,
                        a_old=None, stats=stats.merge_first(st), trig=trig)

        def inner(md, s):
            """Iterate until the limit, convergence, a fail-stop or a
            trigger; every exit leaves ``s`` at its last good iterate."""
            while (s["itr"] < max_itrs and s["stats"].errcode == 0
                   and not s["trig"]):
                gamma = dot(s["r"], s["r"])
                delta = dot(s["w"], s["r"])
                n, trig, st1 = spmv(md, s["w"])
                s["stats"] = s["stats"].merge_first(st1)
                if s["itr"] > 0 and s["itr"] - 1 < trace.shape[0]:
                    # gamma is the previous update's ||r||^2
                    trace[s["itr"] - 1] = gamma
                s["trig"] = trig
                if bool(gamma <= conv):
                    return
                if trig or s["stats"].errcode != 0:
                    return
                if s["g_old"] is None:          # first iteration or restart
                    beta = torch.zeros_like(gamma)
                else:
                    beta = gamma / s["g_old"]
                denom = (delta if s["a_old"] is None
                         else delta - beta * gamma / s["a_old"])
                alpha = gamma / denom
                if bool(denom <= 0) or not bool(torch.isfinite(gamma)):
                    s["stats"] = s["stats"].merge_first(
                        SpmvStats(errcode=ERR_BREAKDOWN))
                    return
                s1 = s["w"] + beta * s["s"]
                z1 = n + beta * s["z"]
                p1 = s["r"] + beta * s["p"]
                s.update(itr=s["itr"] + 1, x=s["x"] + alpha * p1,
                         r=s["r"] - alpha * s1, w=s["w"] - alpha * z1,
                         s=s1, z=z1, p=p1, g_old=gamma, a_old=alpha)

        with span("solver.init"):
            s = init(md, 0, torch.zeros_like(b), b, SpmvStats.clean())
        while True:
            inner(md, s)
            if not (lazy and s["trig"]):
                break
            st1, md = impl.classify(md)
            stats = s["stats"].merge_first(st1)
            if stats.errcode != 0:
                s["stats"] = stats
                break
            # Restart on the scrubbed matrix: products recurred from
            # corrupt data must not survive the repair.
            s = init(md, s["itr"], s["x"], s["r"], stats)

        itr, x, r = s["itr"], s["x"], s["r"]
        rr = dot(r, r)
        if 0 < itr <= trace.shape[0]:
            trace[itr - 1] = rr
        return CGResult(x=x, iterations=itr, rr=rr, stats=s["stats"],
                        rr_trace=trace, md=md)

    return solve
