"""The CG iteration — detect fast, repair rarely — as Python loops.

Counterpart of ``abft_sparse_cg_tpu.solver.cg`` (see its docstring for
the two-level schedule).  The reference's ``lax.while_loop``s become
Python loops around device tensors; the loop conditions read the
residual back to the host, which is what the reference's cg.cpp:93-118
does every iteration too.  The whole-solve CUDA kernel (solver.fused)
is the path that keeps that loop on the device.

The iteration that saw a trigger is re-executed after the repair, so
the iterates never consume corrupted values; fail-stop conditions end
the outer loop with a nonzero error code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.blas1 import calc_p, calc_xr, dot
from ..ops.spmv import ERR_BREAKDOWN, ERR_PHANTOM, SpmvImpl, SpmvStats

__all__ = ["CGResult", "CGState", "make_cg_solver", "make_cg_continue",
           "init_state", "trace_length"]

_MAX_TRACE = 100_000


def trace_length(max_itrs: int) -> int:
    return min(max_itrs, _MAX_TRACE)


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int           # completed iterations
    rr: torch.Tensor          # final squared residual norm (0-d)
    stats: SpmvStats          # accumulated ABFT stats (first events kept)
    rr_trace: torch.Tensor    # rr after each iteration (nan-padded)
    md: object = None         # final MatrixDevice (scrubbed after a repair)


class CGState(NamedTuple):
    """Resumable solver state (x, r, p, rr, rz, itr) + stats + trace."""

    itr: int
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rr: torch.Tensor     # r . r (0-d)
    rz: torch.Tensor     # r . M^-1 r (== rr unpreconditioned)
    stats: SpmvStats
    trace: torch.Tensor


def _iterate(x, r, p, rr, rz, w, pw=None):
    """One CG update (cg.py:81); ``bad`` flags a breakdown: p.A.p not
    positive or a non-finite residual."""
    if pw is None:
        pw = dot(p, w)
    alpha = rz / pw
    x1, r1, rr1 = calc_xr(x, r, p, w, alpha)
    p1 = calc_p(p, r1, rr1 / rz)
    bad = bool(pw <= 0) or not bool(torch.isfinite(rr1))
    return x1, r1, p1, rr1, rr1, bad


def init_state(b: torch.Tensor, max_itrs: int):
    """x0 = 0, r = p = b (cg.cpp:85-88)."""
    rr = dot(b, b)
    return CGState(
        itr=0, x=torch.zeros_like(b), r=b, p=b, rr=rr, rz=rr,
        stats=SpmvStats.clean(),
        trace=torch.full((trace_length(max_itrs),), float("nan"),
                         dtype=b.dtype, device=b.device))


def _conv(conv_threshold, state: CGState) -> torch.Tensor:
    # Compare in the state's dtype, as the reference does.
    return torch.tensor(conv_threshold, dtype=state.rr.dtype,
                        device=state.rr.device)


def make_cg_continue(impl: SpmvImpl, conv_threshold: float):
    """``continue_(md, state, upto) -> (CGState, MatrixDevice)``: advance
    until ``itr == upto``, convergence or a fail-stop (cg.py:131)."""
    if impl.classify is None:
        return _make_simple_continue(impl, conv_threshold)
    return _make_lazy_continue(impl, conv_threshold)


def make_cg_solver(impl: SpmvImpl, max_itrs: int, conv_threshold: float):
    """``solve(md, b) -> CGResult`` around a SpmvImpl."""
    cont = make_cg_continue(impl, conv_threshold)

    def solve(md, b):
        s, md_out = cont(md, init_state(b, max_itrs), max_itrs)
        return CGResult(x=s.x, iterations=s.itr, rr=s.rr, stats=s.stats,
                        rr_trace=s.trace, md=md_out)

    return solve


def _record(trace, itr, rr):
    if itr < trace.shape[0]:
        trace = trace.clone()
        trace[itr] = rr
    return trace


def _make_simple_continue(impl, conv_threshold):
    def continue_(md, state: CGState, upto):
        conv = _conv(conv_threshold, state)
        s = state
        while s.itr < upto and bool(s.rr > conv) and s.stats.errcode == 0:
            if impl.fast_pw is not None:  # mode none: no checks to run
                w, _, pw = impl.fast_pw(md, s.p)
                st1 = SpmvStats.clean()
            else:
                w, st1 = impl.full(md, s.p)
                pw = None
            st = s.stats.merge_first(st1)
            if st1.errcode != 0:
                # On fail-stop the reference dies mid-SpMV: discard.
                s = s._replace(stats=st)
                break
            x1, r1, p1, rr1, rz1, bad = _iterate(s.x, s.r, s.p, s.rr, s.rz,
                                                 w, pw)
            if bad:
                s = s._replace(stats=st.merge_first(
                    SpmvStats(errcode=ERR_BREAKDOWN)))
                break
            s = CGState(s.itr + 1, x1, r1, p1, rr1, rz1, st,
                        _record(s.trace, s.itr, rr1))
        return s, md

    return continue_


def _fast_pw_of(im: SpmvImpl):
    if im.fast_pw is not None:
        return im.fast_pw

    def f(md, p):
        w, trig = im.fast(md, p)
        return w, trig, dot(p, w)

    return f


def _cksum_leaves(md):
    """Stored-checksum baselines of a device matrix; a split's (main,
    tail) pair recurses over its parts (cg.py:219)."""
    if hasattr(md, "cksum"):
        return [md.cksum]
    return [c for part in md for c in _cksum_leaves(part)]


def _baseline_changed(md_before, md_after) -> bool:
    """Did a repair change the stored-checksum baseline (cg.py:233)?"""
    la, lb = _cksum_leaves(md_before), _cksum_leaves(md_after)
    assert len(la) == len(lb), (len(la), len(lb))
    return any(bool(torch.any(a != b)) for a, b in zip(la, lb))


def _phantom_guard(trigged: bool, st1: SpmvStats, consumed: bool,
                   stuck: int):
    """Livelock guard (cg.py:246): a trigger classify cannot attribute —
    no correction, no errcode, and an unchanged checksum baseline — gets
    ONE retry; a second consecutive one fail-stops with ERR_PHANTOM."""
    unprod = (trigged and st1.errcode == 0 and st1.corrected_count == 0
              and not consumed)
    stuck = stuck + 1 if unprod else 0
    if stuck >= 2 and st1.errcode == 0:
        st1 = st1._replace(errcode=ERR_PHANTOM)
    return st1, stuck


def _make_lazy_continue(impl, conv_threshold):
    fast_pw = _fast_pw_of(impl)

    def continue_(md, state: CGState, upto):
        conv = _conv(conv_threshold, state)
        s = state
        while True:
            trig = False
            while (s.itr < upto and bool(s.rr > conv)
                   and s.stats.errcode == 0):
                w, trig_t, pw = fast_pw(md, s.p)
                if bool(trig_t):
                    # A triggered iteration's w may be corrupt: it is
                    # re-executed on the scrubbed matrix.
                    trig = True
                    break
                x1, r1, p1, rr1, rz1, bad = _iterate(
                    s.x, s.r, s.p, s.rr, s.rz, w, pw)
                if bad:
                    s = s._replace(stats=s.stats.merge_first(
                        SpmvStats(errcode=ERR_BREAKDOWN)))
                    break
                s = CGState(s.itr + 1, x1, r1, p1, rr1, rz1, s.stats,
                            _record(s.trace, s.itr, rr1))
            if not trig:
                return s, md
            st1, md = impl.classify(md)
            s = s._replace(stats=s.stats.merge_first(st1))
            if s.stats.errcode != 0:
                return s, md

    return continue_
