"""Whole-solve fused CG: kernels B (``fused_cg_dia``) and D
(``fused_cg_ell``) and their outer loop.

Counterpart of ``abft_sparse_cg_tpu.solver.fused`` for the DIA and
banded-ELL layouts and for bordered splits of either with a dense-plan
tail (``_plan_split``, fused.py:381-436), unpreconditioned, live
detection (check interval 1), every mode.  The fast loop runs inside one
persistent cooperative CUDA kernel (csrc/fused_cg_dia.cu,
csrc/fused_cg_ell.cu) that exits on convergence, ``upto``, a trigger or
a breakdown; a split runs the kernels' instance with the split tail
(span-window dense rows, mirrored AXPYs and the tail's live signals,
csrc/dia_common.cuh).  The rare classify/repair stays the plain ops.spmv
path in the outer loop, with the reference's livelock guard
(fused.py:2120-2148).

``fused_cg_dia`` / ``fused_cg_ell`` launch their kernel for CUDA tensors
and run ``fused_cg_dia_plain`` / ``fused_cg_ell_plain`` — a Python loop
with the same exit semantics — for CPU tensors.  All update x, r and p
in place; an iteration that triggers or breaks down changes none of
them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops.spmv import ERR_BREAKDOWN, SpmvStats, make_spmv
from ..ops.spmv_cuda import (
    DiaSpec,
    EllSpec,
    _check_cuda_args,
    _check_tensor,
    _offsets_arg,
    _ptr,
    _signal_plane,
    _signal_planes,
    dia_fast_plain,
    ell_fast_plain,
    fast_spec,
    gather_mask,
    signals_plain,
)
from .cg import (
    CGResult,
    CGState,
    _baseline_changed,
    _phantom_guard,
    init_state,
)

__all__ = ["supports_fused", "make_fused_continue", "make_fused_solver",
           "fused_cg_dia", "fused_cg_dia_plain", "fused_cg_ell",
           "fused_cg_ell_plain", "TailSpec", "tail_spec", "split_tail_plain"]

_MAX_K = 512        # csrc/dia_common.cuh ABFT_MAX_K
_MAX_T = 64         # csrc/dia_common.cuh ABFT_MAX_T
_TAIL_CHUNK = 2048  # csrc/dia_common.cuh ABFT_TAIL_CHUNK


def supports_fused(mat, dtype) -> bool:
    """The envelope of kernels B and D: a DIA matrix, an ELL matrix of at
    most 512 slots per row, or a bordered split of either whose flat
    tail has a dense plan with 128-aligned spans (fused.py:381-401);
    float32.  Flat matrices and band splits (no dense plan) take the
    per-iteration tier, as on the TPU.  (Every solve of the port is
    unpreconditioned with live detection.)"""
    if dtype != torch.float32 or mat.R % 32:
        return False
    if mat.exec_kind == "split":
        tp = mat.tail.dense_plan
        if tp is None or mat.tail.exec_kind != "flat":
            return False
        rows, starts, S = tp
        if S % 128 or any(st % 128 for st in starts) or len(rows) > _MAX_T:
            return False
        return supports_fused(mat.main, dtype)
    if mat.exec_kind == "dia":
        return len(mat.dia_offsets) > 0
    return mat.exec_kind == "ell" and mat.K <= _MAX_K


class TailSpec(NamedTuple):
    """Static description of a split's dense-plan tail: outlier exec
    rows, span starts, span width, and the tail's signals (``plane`` as
    in ops.spmv_cuda.DiaSpec, over the tail's (E,) planes)."""

    rows: tuple
    starts: tuple
    S: int
    use_parity: bool
    use_cksum: bool
    plane: object


def tail_spec(mat, mode) -> TailSpec:
    rows, starts, S = mat.tail.dense_plan
    return TailSpec(tuple(rows), tuple(starts), S,
                    *_signal_plane(mode, mat.tail))


def split_tail_plain(mdt, ts: TailSpec, p, w):
    """The split tail of kernels B and D in plain PyTorch: ``w`` (the
    main product) plus, for each outlier t in turn, its dense row's dot
    product at o_t and its mirrored AXPY over its window — the kernels'
    order for every element; the dot products themselves are summed in
    another order than the kernels' chunks.  Returns (w, trig, pw)."""
    S = ts.S
    xs = torch.stack([p[st:st + S] for st in ts.starts])
    wa = torch.sum(mdt.dense_td * xs, dim=1)
    w = w.clone()
    for t, (o, st) in enumerate(zip(ts.rows, ts.starts)):
        w[o] = w[o] + wa[t]
        w[st:st + S] = w[st:st + S] + p[o] * mdt.dense_tb[t]
    return w, signals_plain(mdt, ts), torch.sum(p * w)


def _cg_loop_plain(fast_plain, md, spec, x, r, p, rr, rz, itr, upto, conv,
                   trace, tail=None):
    """The fused kernels' loop in plain PyTorch around one product (and
    ``tail`` = (tail MatrixDevice, TailSpec) of a split)."""
    conv_t = torch.tensor(conv, dtype=rr.dtype, device=rr.device)
    trig = err = 0
    while itr < upto and bool(rr > conv_t):
        w, t, pw = fast_plain(md, p, spec)
        if tail is not None:
            w, tt, pw = split_tail_plain(tail[0], tail[1], p, w)
            t = t | tt
        alpha = rz / pw
        r1 = r - alpha * w
        rr1 = torch.sum(r1 * r1)
        if bool(t):
            trig = 1
            break
        if bool(pw <= 0) or not bool(torch.isfinite(rr1)):
            err = ERR_BREAKDOWN
            break
        x.copy_(x + alpha * p)
        r.copy_(r1)
        p.copy_(r1 + (rr1 / rz) * p)
        if itr < trace.shape[0]:
            trace[itr] = rr1
        itr, rr, rz = itr + 1, rr1, rr1
    return itr, rr, rz, trig, err


def fused_cg_dia_plain(md, spec: DiaSpec, x, r, p, rr, rz, itr: int,
                       upto: int, conv: float, trace, tail=None):
    """Plain version of kernel B.  Returns (itr, rr, rz, trig, err)."""
    return _cg_loop_plain(dia_fast_plain, md, spec, x, r, p, rr, rz, itr,
                          upto, conv, trace, tail)


def fused_cg_ell_plain(md, spec: EllSpec, x, r, p, rr, rz, itr: int,
                       upto: int, conv: float, trace, tail=None):
    """Plain version of kernel D.  Returns (itr, rr, rz, trig, err)."""
    return _cg_loop_plain(ell_fast_plain, md, spec, x, r, p, rr, rz, itr,
                          upto, conv, trace, tail)


def _tail_args(what, tail, R, device):
    """The split-tail arguments of the C interface (all null and T = 0
    without a tail), validated."""
    if tail is None:
        return dict(ptrs=(None, None, None, None, 0, 0, None, None, None, 0),
                    keep=())
    mdt, ts = tail
    T, S = len(ts.rows), ts.S
    if (not 1 <= T <= _MAX_T or S % 128 or S > R
            or not all(0 <= o < R for o in ts.rows)
            or not all(0 <= st <= R - S for st in ts.starts)):
        raise ValueError(f"{what}: a tail of {T} rows of span {S} does "
                         f"not fit {R} rows")
    E = mdt.values.shape[0] if mdt.values is not None else 0
    for name, t in (("dense_td", mdt.dense_td), ("dense_tb", mdt.dense_tb)):
        _check_tensor(what, name, t, torch.float32, (T, S), device)
    plane, base = _signal_planes(mdt, ts)
    if plane is not None:
        _check_tensor(what, "tail signal plane", plane, torch.int32, (E,),
                      device)
        _check_tensor(what, "tail baseline", base, torch.int32, (E // 8,),
                      device)
    rows, rows_ptr = _offsets_arg(ts.rows)
    starts, starts_ptr = _offsets_arg(ts.starts)
    part = torch.empty(T * -(-S // _TAIL_CHUNK), dtype=torch.float32,
                       device=device)
    return dict(ptrs=(mdt.dense_td.data_ptr(), mdt.dense_tb.data_ptr(),
                      rows_ptr, starts_ptr, T, S, part.data_ptr(),
                      _ptr(plane), _ptr(base), E),
                keep=(rows, starts, part))


def _launch_args(what, md, spec, x, r, p, rr, rz, itr, upto, trace,
                 tail=None):
    """Validated tensors and the scratch one cooperative launch needs."""
    D, R, plane, base, gsrc = _check_cuda_args(md, p, spec, what)
    for name, t in (("x", x), ("r", r), ("p", p), ("trace", trace)):
        if (t.dtype != torch.float32 or t.device != p.device
                or not t.is_contiguous() or t.dim() != 1):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"1-D float32 tensor on {p.device}")
    if x.shape[0] != R or r.shape[0] != R:
        raise ValueError(f"{what}: x, r, p must have R rows")
    dev = p.device.index if p.device.index is not None else 0
    grid = fused_grid(dev, "ell" if isinstance(spec, EllSpec) else "dia",
                      tail is not None)
    f32 = dict(dtype=torch.float32, device=p.device)
    i32 = dict(dtype=torch.int32, device=p.device)
    return dict(
        D=D, R=R, plane=plane, base=base, gsrc=gsrc, dev=dev, grid=grid,
        w=torch.empty(R, **f32),
        part_pw=torch.empty(grid, **f32), part_rr=torch.empty(grid, **f32),
        part_flag=torch.empty(grid, **i32),
        iscal_in=torch.tensor([itr, upto], **i32),
        fscal_in=torch.stack([rr.to(torch.float32), rz.to(torch.float32)]),
        iscal_out=torch.empty(3, **i32), fscal_out=torch.empty(2, **f32),
        stream=torch.cuda.current_stream(p.device).cuda_stream,
        tail=_tail_args(what, tail, R, p.device))


def _launch_result(a):
    itr_out, trig, err = (int(v) for v in a["iscal_out"].tolist())
    return itr_out, a["fscal_out"][0], a["fscal_out"][1], trig, err


def fused_cg_dia(md, spec: DiaSpec, x, r, p, rr, rz, itr: int, upto: int,
                 conv: float, trace, tail=None):
    """Kernel B: run CG iterations ``itr .. upto`` in place on x, r, p.

    ``rr``/``rz`` are 0-d tensors, ``trace`` a float tensor whose slots
    [itr, itr_out) get the new residuals; ``tail`` = (tail MatrixDevice,
    TailSpec) runs the split-tail instance.  Returns (itr, rr, rz, trig,
    err) with ints for itr/trig/err and 0-d tensors for rr/rz."""
    if x.device.type == "cpu":
        return fused_cg_dia_plain(md, spec, x, r, p, rr, rz, itr, upto,
                                  conv, trace, tail)
    from .._build import check, library

    a = _launch_args("fused_cg_dia", md, spec, x, r, p, rr, rz, itr, upto,
                     trace, tail)
    offs, offs_ptr = _offsets_arg(spec.offsets)
    rc = library("fused_cg_dia").abft_fused_cg_dia(
        md.values.data_ptr(), offs_ptr, a["D"], a["R"], x.data_ptr(),
        r.data_ptr(), p.data_ptr(), a["w"].data_ptr(), _ptr(a["plane"]),
        _ptr(a["base"]), int(spec.use_parity), int(spec.use_cksum),
        a["part_pw"].data_ptr(), a["part_rr"].data_ptr(),
        a["part_flag"].data_ptr(), a["grid"], a["iscal_in"].data_ptr(),
        a["fscal_in"].data_ptr(), a["iscal_out"].data_ptr(),
        a["fscal_out"].data_ptr(), trace.data_ptr(), trace.shape[0],
        float(conv), *a["tail"]["ptrs"], a["dev"], a["stream"])
    del offs
    check(rc, "fused_cg_dia cooperative launch")
    fused_cg_dia.launches += 1
    if tail is not None:
        fused_cg_dia.tail_launches += 1
    return _launch_result(a)


fused_cg_dia.launches = 0
fused_cg_dia.tail_launches = 0   # the split-tail instance's share


def fused_cg_ell(md, spec: EllSpec, x, r, p, rr, rz, itr: int, upto: int,
                 conv: float, trace, tail=None):
    """Kernel D: kernel B's contract over a banded-ELL matrix."""
    if x.device.type == "cpu":
        return fused_cg_ell_plain(md, spec, x, r, p, rr, rz, itr, upto,
                                  conv, trace, tail)
    from .._build import check, library

    a = _launch_args("fused_cg_ell", md, spec, x, r, p, rr, rz, itr, upto,
                     trace, tail)
    rc = library("fused_cg_ell").abft_fused_cg_ell(
        md.values.data_ptr(), a["gsrc"].data_ptr(), gather_mask(spec),
        md.ell_len.data_ptr(), a["D"], a["R"], x.data_ptr(), r.data_ptr(),
        p.data_ptr(), a["w"].data_ptr(), _ptr(a["plane"]), _ptr(a["base"]),
        int(spec.use_parity), int(spec.use_cksum), a["part_pw"].data_ptr(),
        a["part_rr"].data_ptr(), a["part_flag"].data_ptr(), a["grid"],
        a["iscal_in"].data_ptr(), a["fscal_in"].data_ptr(),
        a["iscal_out"].data_ptr(), a["fscal_out"].data_ptr(),
        trace.data_ptr(), trace.shape[0], float(conv), *a["tail"]["ptrs"],
        a["dev"], a["stream"])
    check(rc, "fused_cg_ell cooperative launch")
    fused_cg_ell.launches += 1
    if tail is not None:
        fused_cg_ell.tail_launches += 1
    return _launch_result(a)


fused_cg_ell.launches = 0
fused_cg_ell.tail_launches = 0

_grids = {}


def fused_grid(device_index: int, layout: str, tail: bool = False) -> int:
    """Co-resident grid of kernel B ("dia") or D ("ell"), tail-free or
    with the split tail, on a device (SMs x blocks per SM)."""
    key = (device_index, layout, tail)
    if key not in _grids:
        from .._build import check, library

        out = ctypes.c_int(0)
        if layout == "dia":
            rc = library("fused_cg_dia").abft_fused_grid(
                device_index, int(tail), ctypes.addressof(out))
        else:
            rc = library("fused_cg_ell").abft_fused_ell_grid(
                device_index, int(tail), ctypes.addressof(out))
        check(rc, f"fused_cg_{layout} occupancy query")
        _grids[key] = out.value
    return _grids[key]


def make_fused_continue(mat, mode, conv_threshold):
    """``continue_(md, state, upto) -> (CGState, MatrixDevice)`` with
    solver.cg's contract, the fast loop in kernel B or D
    (fused.py:1946).  A split's ``md`` is the (main, tail) pair."""
    split = mat.exec_kind == "split"
    spec = fast_spec(mat.main if split else mat, mode)
    tspec = tail_spec(mat, mode) if split else None
    kernel = fused_cg_dia if isinstance(spec, DiaSpec) else fused_cg_ell
    classify = make_spmv(mat, torch.float32, mode).classify

    def run_fast(md, s: CGState, upto: int):
        ktrace = torch.full_like(s.trace, float("nan"))
        tail = None
        if split:
            md, tail = md[0], (md[1], tspec)
        itr, rr, rz, trig, err = kernel(
            md, spec, s.x, s.r, s.p, s.rr, s.rz, s.itr, upto,
            conv_threshold, ktrace, tail)
        # Merge the kernel's trace: it wrote slots [s.itr, itr) only.
        tio = torch.arange(s.trace.shape[0], device=s.trace.device)
        trace = torch.where((tio >= s.itr) & (tio < itr), ktrace, s.trace)
        return s._replace(itr=itr, rr=rr, rz=rz, trace=trace), trig, err

    def continue_(md, state: CGState, upto):
        upto = int(upto)
        # The kernel updates x, r, p in place: work on copies so the
        # caller's state stays as it was.
        s = state._replace(x=state.x.clone(), r=state.r.clone(),
                           p=state.p.clone())
        if spec.plane is None and (tspec is None or tspec.plane is None):
            # Mode none: no detection, no repair — one launch runs the
            # loop to convergence, the limit or a breakdown.
            s, _trig, err = run_fast(md, s, upto)
            return s._replace(stats=s.stats.merge_first(
                SpmvStats(errcode=err))), md
        stuck = 0
        while True:
            s, trig, err = run_fast(md, s, upto)
            st1 = SpmvStats.clean()
            md_in = md
            if trig:
                st1, md = classify(md)
            st1, stuck = _phantom_guard(bool(trig), st1,
                                        _baseline_changed(md_in, md), stuck)
            st = s.stats.merge_first(
                SpmvStats(errcode=err)).merge_first(st1)
            s = s._replace(stats=st)
            if not trig or st.errcode != 0:
                return s, md

    return continue_


def make_fused_solver(mat, mode, max_itrs: int, conv_threshold: float):
    """``solve(md, b) -> CGResult`` on kernel B or D."""
    cont = make_fused_continue(mat, mode, conv_threshold)

    def solve(md, b):
        s, md_out = cont(md, init_state(b, max_itrs), max_itrs)
        return CGResult(x=s.x, iterations=s.itr, rr=s.rr, stats=s.stats,
                        rr_trace=s.trace, md=md_out)

    return solve
