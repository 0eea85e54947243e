"""The CG iteration — detect fast, repair rarely — as Python loops.

Counterpart of ``abft_sparse_cg_tpu.solver.cg`` (see its docstring for
the two-level schedule).  The reference's ``lax.while_loop``s become
Python loops around device tensors; the loop conditions read the
residual back to the host, which is what the reference's cg.cpp:93-118
does every iteration too.  The whole-solve CUDA kernel (solver.fused)
is the path that keeps that loop on the device.

The iteration that saw a trigger is re-executed after the repair, so
the iterates never consume corrupted values; fail-stop conditions end
the outer loop with a nonzero error code.  Every solver takes the
Jacobi M^-1 diagonal as ``minv`` (None unpreconditioned).
``make_lazy_ci_solver`` is the lazy ``--check-interval`` schedule of
the per-iteration tier (cg.py:325): a detection-free product on
unchecked iterations, a verified snapshot, and ``_lazy_exit_resolve``'s
rollback, which solver.fused's lazy outer loop shares.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.blas1 import calc_p, calc_xr, dot
from ..ops.spmv import ERR_BREAKDOWN, ERR_PHANTOM, SpmvImpl, SpmvStats
from ..tracing import count, span

__all__ = ["CGResult", "CGState", "make_cg_solver", "make_cg_continue",
           "make_lazy_ci_continue", "make_lazy_ci_solver", "init_state",
           "trace_length", "solver_of"]

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


def _iterate(x, r, p, rr, rz, w, minv=None, pw=None):
    """One (P)CG update (cg.py:81); ``minv`` is the Jacobi M^-1 diagonal
    or None.  ``bad`` flags a breakdown: p.A.p not positive or a
    non-finite residual."""
    if pw is None:
        pw = dot(p, w)
    alpha = rz / pw
    x1, r1, rr1 = calc_xr(x, r, p, w, alpha)
    if minv is None:
        rz1 = rr1
        p1 = calc_p(p, r1, rr1 / rz)
    else:
        z = minv * r1
        rz1 = dot(r1, z)
        p1 = calc_p(p, z, rz1 / rz)
    bad = bool(pw <= 0) or not bool(torch.isfinite(rr1))
    return x1, r1, p1, rr1, rz1, bad


@span("solver.init")
def init_state(b: torch.Tensor, max_itrs: int, minv=None):
    """x0 = 0, r = b, p = M^-1 r (r itself unpreconditioned;
    cg.cpp:85-88)."""
    rr = dot(b, b)
    if minv is None:
        p0, rz = b, rr
    else:
        p0 = minv * b
        rz = dot(b, p0)
    return CGState(
        itr=0, x=torch.zeros_like(b), r=b, p=p0, rr=rr, rz=rz,
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
    """``solve(md, b, minv=None) -> CGResult`` around a SpmvImpl;
    ``minv`` is the Jacobi M^-1 diagonal, an (R,) vector, or None."""
    return solver_of(make_cg_continue(impl, conv_threshold), max_itrs)


def solver_of(cont, max_itrs):
    """``solve(md, b, minv=None) -> CGResult``: a continue function run
    from the initial state to ``max_itrs``."""
    @span("solver.solve")
    def solve(md, b, minv=None):
        s, md_out = cont(md, init_state(b, max_itrs, minv), max_itrs, minv)
        return CGResult(x=s.x, iterations=s.itr, rr=s.rr, stats=s.stats,
                        rr_trace=s.trace, md=md_out)

    return solve


def _record(trace, itr, rr):
    if itr < trace.shape[0]:
        trace = trace.clone()
        trace[itr] = rr
    return trace


def _make_simple_continue(impl, conv_threshold):
    def continue_(md, state: CGState, upto, minv=None):
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
                                                 w, minv, pw)
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
    for a, b in zip(la, lb):
        count("solver.host_reads")
        if bool(torch.any(a != b)):
            return True
    return False


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

    def continue_(md, state: CGState, upto, minv=None):
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
                    s.x, s.r, s.p, s.rr, s.rz, w, minv, pw)
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


def _lazy_exit_resolve(md, s1: CGState, snap: CGState, trig: bool, err: int,
                       verify, classify, stuck=None):
    """Trigger/rollback resolution of the lazy ``--check-interval``
    schedules, this per-iteration tier's and solver.fused's (cg.py:268;
    the predicate lives in one place).

    ``verify(md, p) -> bool`` closes the unverified window of a clean
    exit (skipped when the window already triggered).  An anomaly — a
    trigger, or a breakdown — classifies; a correction, a benign
    constraints adoption or a trigger classify explains rolls back to
    the snapshot and retries; an uncorrectable detection rolls back and
    fail-stops; a fault-free breakdown stands.  Returns (done, md, s2)
    and, with ``stuck``, the phantom guard's count."""
    trigged = bool(trig) or bool(verify(md, s1.p))
    md_in = md
    st1 = SpmvStats.clean()
    if trigged or err != 0:
        st1, md = classify(md)
    if stuck is not None:
        st1, stuck = _phantom_guard(
            trigged, st1, trigged and _baseline_changed(md_in, md), stuck)
    fixed = (trigged or st1.corrected_count > 0) and st1.errcode == 0
    roll = fixed or st1.errcode != 0
    brk = 0 if fixed else err
    st = s1.stats.merge_first(st1._replace(
        errcode=st1.errcode if st1.errcode != 0 else brk))
    base = snap if roll else s1
    s2 = base._replace(stats=st, trace=s1.trace)
    done = (not fixed) or st.errcode != 0
    if stuck is not None:
        return done, md, s2, stuck
    return done, md, s2


def make_lazy_ci_continue(impl: SpmvImpl, product: SpmvImpl,
                          check_interval: int, conv_threshold: float):
    """Lazy ``--check-interval`` schedule of the per-iteration tier
    (cg.py:325): iteration ``itr`` runs the checked ``impl`` when ``itr
    % CI == CI - 1`` and the detection-free ``product`` otherwise, whose
    trigger is never read.  A checked iteration that stands becomes the
    verified snapshot (the entry state seeds it); any anomaly, or the
    one checked product that closes the window on every exit, resolves
    through ``_lazy_exit_resolve`` and re-executes from the snapshot."""
    CI = int(check_interval)
    assert CI > 1 and impl.classify is not None
    checked = _fast_pw_of(impl)
    prod = _fast_pw_of(product)

    def verify(md, p):
        return bool(checked(md, p)[1])

    def continue_(md, state: CGState, upto, minv=None):
        conv = _conv(conv_threshold, state)
        s = snap = state
        stuck = 0
        while True:
            trig, err = False, 0
            while s.itr < upto and bool(s.rr > conv):
                chk = s.itr % CI == CI - 1
                w, trig_t, pw = (checked if chk else prod)(md, s.p)
                if chk and bool(trig_t):
                    trig = True
                    break
                x1, r1, p1, rr1, rz1, bad = _iterate(
                    s.x, s.r, s.p, s.rr, s.rz, w, minv, pw)
                if bad:
                    err = ERR_BREAKDOWN
                    break
                s = CGState(s.itr + 1, x1, r1, p1, rr1, rz1, s.stats,
                            _record(s.trace, s.itr, rr1))
                if chk:
                    snap = s
            done, md, s, stuck = _lazy_exit_resolve(
                md, s, snap, trig, err, verify, impl.classify, stuck)
            if done:
                return s, md

    return continue_


def make_lazy_ci_solver(impl: SpmvImpl, product: SpmvImpl,
                        check_interval: int, max_itrs: int,
                        conv_threshold: float):
    """``solve(md, b, minv=None) -> CGResult`` on the per-iteration lazy
    schedule (make_lazy_ci_continue)."""
    return solver_of(make_lazy_ci_continue(impl, product, check_interval,
                                           conv_threshold), max_itrs)
